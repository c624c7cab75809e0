"""The serving engine's sampling core: the hand-written kernel of
``csrc/sampling.cu`` and its plain PyTorch version.

:func:`sample` computes what ``paddle_tpu/serving/sampling.py``
``sample_tokens`` computes, row by row: the constraint mask applied as
``-inf``, ``argmax`` for a row with ``temperature <= 0``, else temperature
scaling, top-k and top-p truncation by 64-step value bisections, and an
inverse-CDF draw under the positional threefry key
``fold_in(PRNGKey(seed), position)`` (:mod:`paddle_tpu_torch.core.rng`,
bit-equal to ``jax.random``). It returns the tokens and the drawn uniforms.

The JAX package computes this with XLA ops and skips the sampled branch of
an all-greedy batch with a ``lax.cond`` on device data. A captured CUDA
graph cannot branch on device data, and the same function in PyTorch ops
would add some 900 nodes to every decode step, greedy or not. So on the
card it is one kernel that branches per row and leaves a greedy row after
its argmax.

Route: :func:`sample` runs the plain version :func:`sample_ref` only
because its tensors lie on the CPU. On a CUDA tensor it launches the kernel
(built on first use by :mod:`._build`) or raises; nothing falls back.
``launches`` counts the kernel's launches, one per launch, and nothing
else. The plain version transcribes the JAX function in PyTorch ops with no
branch on the host: it computes both branches and selects with
``torch.where``, as the JAX function's last line does, so a captured step on
the CPU's route sees no data-dependent ``if`` either.

On the card each row is split across a thread block cluster of
:data:`CLUSTER` CTAs; the top-k
and top-p thresholds are found exactly (a pass over value buckets, then
the crossing bucket's entries sorted; a radix select over the keys where a
bucket is crowded) and the JAX function's 64 bisection steps are replayed
on scalars against them, so the kept sets are the bisection's. The kernel reads bf16 and float16 logits in
their own type (the conversion is exact); nothing is cast or allocated per
launch beside the tokens and draws. :func:`row_resident` decides once per
device, vocabulary width and dtype whether each CTA keeps its slice of the
row in shared memory.

Bound on an H100 SXM: the logits and the mask are read once (about 2.0 MB
at 8 x 50304 in float32, 1.2 MB in bf16). The kernel's design, its barrier
count and its known costs are in its source.
"""
from __future__ import annotations

import ctypes
import types

import torch

from ..core import rng

__all__ = ["sample", "sample_ref", "draw_margin", "launches",
           "reset_launches", "load_kernels", "row_resident", "slice_len",
           "CLUSTER", "MAX_VOCAB"]

#: kernel launches, one per launch
launches = {"sample_tokens": 0}
#: CTAs a row is split across (the kernel's kCluster, the largest portable
#: cluster)
CLUSTER = 8
_VEC = 8     # a slice is a multiple of 8 logits (the kernel's kVec)
#: the widest row whose indices the kernel keeps in int32 (each rank's
#: slice is rounded up to a multiple of 8 within them)
MAX_VOCAB = 2 ** 31 - 1 - _VEC * CLUSTER
_STEPS = 64  # bisection steps, as the JAX function
_DTYPE_CODES = types.MappingProxyType(  # as paged_attention's
    {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2})
_lib = None
#: the kernel's form per (device, vocab, dtype): see row_resident
_plans = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def load_kernels() -> ctypes.CDLL:
    """Build (on first use) and load the CUDA library; bind its launcher."""
    global _lib
    # analysis: allow(mutable-global-capture) — the library handle, bound
    # once (the warm-up loads it); a graph bakes in the kernel it launches
    if _lib is None:
        from ._build import library

        lib = library("sampling")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.sample_tokens_launch.argtypes = ([i32] + [ptr] * 9
                                             + [i32] * 3 + [ptr])
        lib.sample_tokens_launch.restype = i32
        lib.sample_tokens_plan.argtypes = [i32, i32, ptr]
        lib.sample_tokens_plan.restype = i32
        _lib = lib
    return _lib


def slice_len(vocab: int) -> int:
    """Logits of one rank's slice of a row (the kernel's ``slice_len``):
    ``ceil(vocab / CLUSTER)`` rounded up to 8; rank ``c`` owns
    ``[c * slice, (c + 1) * slice)`` of the row, the last ranks fewer or
    none."""
    per = -(-vocab // CLUSTER)
    return -(-per // _VEC) * _VEC


def row_resident(device: torch.device, vocab: int,
                 dtype: torch.dtype) -> bool:
    """Whether each CTA keeps its slice of a row of ``vocab`` logits of
    ``dtype`` (its s and probabilities) in shared memory on ``device``, or
    reads the slice again from the logits at every pass: decided on first
    use by the kernel's own ``sample_tokens_plan`` (the slice fits, and
    ``cudaOccupancyMaxActiveClusters`` finds room for the cluster; on an
    H100, rows of up to about 196K logits: 227 KB a CTA less the kernel's
    36 KB of static shared memory) and kept. It depends on the row's width
    only, never on the number of rows, so a row gives the same bits alone
    (a prefill's ``[1, V]``) and in a batch (the decode step). A serving
    engine's warm-up makes it before any capture."""
    key = (device, vocab, dtype)
    # analysis: allow(mutable-global-capture) — decided once per device and
    # shape before any capture (the warm-up launches first) and kept, as
    # paged_attention's split count: a graph bakes in the launch it made
    if key not in _plans:
        resident = (ctypes.c_int * 1)()
        with torch.cuda.device(device):
            rc = load_kernels().sample_tokens_plan(_DTYPE_CODES[dtype], vocab,
                                                   resident)
        if rc != 0:
            raise RuntimeError(f"sample_tokens_plan failed: CUDA error {rc}")
        _plans[key] = bool(resident[0])
    return _plans[key]


def _bisect(pred, lo, hi):
    """64 bisections of ``[lo, hi]`` per row: ``pred(mid) -> [R] bool``
    moves ``lo`` up where true, ``hi`` down where false."""
    for _ in range(_STEPS):
        mid = 0.5 * (lo + hi)
        ok = pred(mid)
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return lo, hi


def _truncate(logits, temperature, top_k, top_p, allowed):
    """Steps 1-5 of the JAX function: the greedy tokens ``[R]``, the scaled
    row after the top-k cut and its softmax ``[R, V]``, the finite range
    ``lo0``/``hi0`` and the two bisections' thresholds ``kth`` (the top-k
    bracket's lower end) and ``p_thresh`` (the top-p bracket's upper end),
    each ``[R]``."""
    vocab = logits.shape[-1]
    logits = logits.float()
    if allowed is not None:
        logits = torch.where(allowed.bool(), logits, -torch.inf)
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp_min(temperature.float(), 1e-6)[:, None]
    finite = torch.isfinite(scaled)
    lo0 = torch.where(finite, scaled, torch.inf).amin(dim=-1)
    hi0 = torch.where(finite, scaled, -torch.inf).amax(dim=-1)
    k_eff = top_k.long().clamp(0, vocab)
    k_min1 = k_eff.clamp_min(1)
    kth, _ = _bisect(lambda mid: (scaled >= mid[:, None]).sum(-1) >= k_min1,
                     lo0, hi0)
    scaled = torch.where((k_eff > 0)[:, None] & (scaled < kth[:, None]),
                         -torch.inf, scaled)
    p = top_p.float()
    probs = torch.softmax(scaled, dim=-1)
    _, p_thresh = _bisect(
        lambda mid: torch.where(scaled > mid[:, None], probs, 0.0).sum(-1)
        >= p, lo0, hi0)
    return dict(greedy=greedy, scaled=scaled, probs=probs, lo0=lo0, hi0=hi0,
                kth=kth, p_thresh=p_thresh)


def _kept_cdf(logits, temperature, top_k, top_p, allowed):
    """The greedy tokens ``[R]`` and the sampled rows' inclusive prefix sum
    of the kept probabilities ``[R, V]``: steps 1-6 of the JAX function."""
    t = _truncate(logits, temperature, top_k, top_p, allowed)
    p = top_p.float()
    p_on = ((p > 0.0) & (p < 1.0))[:, None]
    probs = torch.where(~p_on | (t["scaled"] >= t["p_thresh"][:, None]),
                        t["probs"], 0.0)
    return t["greedy"], torch.cumsum(probs, dim=-1)


def sample_ref(logits, temperature, top_k, top_p, seeds, positions,
               allowed=None):
    """Plain version: ``(tokens [R] int64, u [R] float32)`` from ``logits
    [R, V]``, the JAX function's steps in PyTorch ops (see the module
    docstring); ``u`` is every row's uniform draw, floored at 1e-12."""
    greedy, cum = _kept_cdf(logits, temperature, top_k, top_p, allowed)
    keys = rng.fold_in(rng.prng_key(seeds.int()), positions.int())
    u = torch.clamp_min(rng.uniform(keys), 1e-12)
    draw = (u * cum[:, -1])[:, None]
    sampled = torch.clamp_max((cum < draw).sum(-1), logits.shape[-1] - 1)
    return torch.where(temperature > 0.0, sampled, greedy), u


def draw_margin(logits, temperature, top_k, top_p, allowed, u, tokens):
    """How far each row's ``tokens`` lie from its draw: the distance from
    ``u * cum[-1]`` to the token's interval ``[cum[t-1], cum[t])`` of the
    plain version's ``cum`` over these logits (0 inside it), over
    ``cum[-1]``. A token that another computation of the same draw chose
    (the kernel's sums, XLA's, or logits from another attention route) is
    explained by rounding when this is a few ulps of the total."""
    _, cum = _kept_cdf(logits, temperature, top_k, top_p, allowed)
    total = cum[:, -1]
    draw = u * total
    t = tokens.long()[:, None]
    hi = cum.gather(1, t)[:, 0]
    lo = torch.where(t[:, 0] > 0, cum.gather(1, (t - 1).clamp_min(0))[:, 0],
                     torch.zeros_like(hi))
    gap = torch.clamp_min(torch.maximum(lo - draw, draw - hi), 0.0)
    return gap / total.clamp_min(torch.finfo(torch.float32).tiny)


def sample(logits, temperature, top_k, top_p, seeds, positions,
           allowed=None):
    """Next tokens ``[R]`` int64 and the drawn uniforms ``[R]`` float32
    from ``logits [R, V]`` (float32, bfloat16 or float16: the values of
    their float32 cast, as the JAX function takes them), ``temperature``/
    ``top_p`` ``[R]`` float, ``top_k``/``seeds``/``positions`` ``[R]`` int
    and ``allowed`` ``[R, V]`` bool (None: every token allowed).
    ``positions`` is each token's positional key. The plain version on the
    CPU, the kernel on a CUDA device."""
    if logits.device.type == "cpu":
        return sample_ref(logits, temperature, top_k, top_p, seeds,
                          positions, allowed)
    return _launch(logits, temperature, top_k, top_p, seeds, positions,
                   allowed)


def _launch(logits, temperature, top_k, top_p, seeds, positions, allowed):
    """Check what the kernel takes, launch it on the current stream and
    return ``(tokens, u)``."""
    if logits.dim() != 2:
        raise ValueError(f"logits must be [rows, vocab], got "
                         f"{tuple(logits.shape)}")
    if logits.dtype not in _DTYPE_CODES:
        raise TypeError(f"the sampling kernel takes float32, bfloat16 or "
                        f"float16 logits, got {logits.dtype}")
    rows, vocab = logits.shape
    if vocab > MAX_VOCAB:
        raise ValueError(f"the sampling kernel indexes a row in int32: at "
                         f"most {MAX_VOCAB} logits, got {vocab}")
    logits = logits.contiguous()
    params = (temperature.float().contiguous(), top_k.int().contiguous(),
              top_p.float().contiguous(), seeds.int().contiguous(),
              positions.int().contiguous())
    if allowed is not None:
        if allowed.shape != logits.shape:
            raise ValueError(f"allowed {tuple(allowed.shape)} does not match "
                             f"logits {tuple(logits.shape)}")
        allowed = allowed.contiguous().view(torch.uint8)
    for t in params + ((allowed,) if allowed is not None else ()):
        if not t.is_cuda or t.device != logits.device:
            raise ValueError("every operand must lie on the logits' CUDA "
                             "device")
    for t in params:
        if t.shape != (rows,):
            raise ValueError(f"per-row operands must be [{rows}], got "
                             f"{tuple(t.shape)}")
    resident = row_resident(logits.device, vocab, logits.dtype)
    tokens = torch.empty(rows, dtype=torch.int64, device=logits.device)
    u = torch.empty(rows, dtype=torch.float32, device=logits.device)
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    rc = load_kernels().sample_tokens_launch(
        _DTYPE_CODES[logits.dtype], logits.data_ptr(),
        allowed.data_ptr() if allowed is not None else None,
        *(t.data_ptr() for t in params), tokens.data_ptr(), u.data_ptr(),
        rows, vocab, int(resident), stream)
    if rc != 0:
        raise RuntimeError(f"sample_tokens_launch failed: CUDA error {rc}")
    # analysis: allow(mutable-global-capture) — a capture counts here once;
    # serving.graphs takes that back out and credits it on every replay
    launches["sample_tokens"] += 1
    return tokens, u
