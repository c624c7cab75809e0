"""Paged attention over the KV arena's block tables (counterpart of
``paddle_tpu/ops/paged_attention.py``).

Three public functions under their JAX names, each with its plain PyTorch
version beside it:

* :func:`paged_decode_attention` -- one new query per slot against that
  slot's paged K/V. Replaces the TPU kernel
  ``paddle_tpu/ops/paged_attention.py:_decode_kernel``.
* :func:`paged_prefill_attention` -- one slot's suffix/chunk queries at
  global positions ``prefix_len + i`` through its table. Replaces
  ``paddle_tpu/ops/paged_attention.py:_prefill_kernel``.
* :func:`paged_full_prefill_attention` -- a cache-miss prefill's contiguous
  K/V viewed through an ``arange`` pseudo-table at prefix 0, through the
  same prefill kernel.

Route: a wrapper runs its plain version only because its tensors lie on the
CPU. On a CUDA tensor it launches the hand-written kernel of
``csrc/paged_attention.cu`` (built on first use by :mod:`._build`) or
raises; nothing falls back. ``launches`` counts kernel launches per kernel,
one per launch, and nothing else.

Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16): decode does about one
FLOP per K/V byte, so it is bound by reading the K/V rows up to each slot's
position; prefill at the engine's buckets is too small for either rate and
is bound by latency. Both kernels read each needed K/V row once and never
read a block past the position. The decode kernel splits each slot's walk
over several thread blocks, reads 16 bytes a lane and merges the splits in
the same launch, in split order, through a workspace and ticket counters
this module owns (:func:`_workspace`), one set per stream the launches run
in order on (:func:`workspace_stream`); the output is the same bits on
every launch. With bf16 queries at head_dim <= 128 the prefill kernel runs on the
tensor cores (``mma.sync``) over 64-key tiles that ``cp.async`` gathers
through the table ahead of the products; float32, float16 and head_dim 256
take its CUDA-core form. :func:`load_alignment` gives what each form needs
of q's and the pools' alignment. Query dtypes float32, bfloat16 and
float16, head dims 32, 64, 128 and 256 (:func:`check_servable`); see the
source for the designs.

The K/V pools are updated in place by the engine, so these functions only
read them. A pool entry is ``(k, v)`` in q's dtype or, from an int8 arena,
``(k, v, k_scale, v_scale)``: int8 payloads with float32 ``[num_blocks,
block_size]`` per-token-row scales. The int8 entry launches the int8
instances of both kernels (``paged_*_attention_int8_launch``, counted
apart), which dequantize each element as they load it: the float32
product of payload and scale, rounded once to q's dtype
(:func:`paddle_tpu_torch.quantization.dequantize_kv`). The plain versions
dequantize the gathered context the same way.
:func:`paged_full_prefill_attention` reads the chunk's own full-precision
K/V, as in the JAX package.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import threading
import types

import torch
import torch.nn.functional as F

from ..models.gpt import masked_attention
from ..quantization import dequantize_kv

__all__ = ["paged_decode_attention", "paged_prefill_attention",
           "paged_full_prefill_attention", "paged_decode_attention_ref",
           "paged_prefill_attention_ref", "paged_full_prefill_attention_ref",
           "launches", "reset_launches", "load_kernels", "load_alignment",
           "aligned", "check_servable", "workspace_stream"]

#: kernel launches, one per launch of each CUDA kernel (``_int8``: the
#: variants over an int8 arena)
launches = {"paged_decode_attention": 0, "paged_prefill_attention": 0,
            "paged_decode_attention_int8": 0,
            "paged_prefill_attention_int8": 0}

_DTYPE_CODES = types.MappingProxyType(
    {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2})
HEAD_DIMS = (32, 64, 128, 256)
_lib = None
#: the decode kernel's split partials, ticket counters and split count, per
#: device, stream and shape (see :func:`_workspace`)
_work = {}
#: per thread: the stream a program being built will replay on
#: (:func:`workspace_stream`)
_owner = threading.local()
#: the decode kernel's most splits per (slot, head) (``kMaxMerge`` in the
#: source), and the thread blocks per SM its grid aims at in one wave
MAX_SPLITS, WAVE_BLOCKS = 64, 4


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def check_servable(head_dim: int, dtype, device) -> None:
    """Raise unless the paged kernels serve ``head_dim`` and ``dtype`` on
    ``device``: on a CUDA device the head dims of :data:`HEAD_DIMS` and the
    float32, bfloat16 and float16 queries the kernels are built for
    (``ValueError`` / ``TypeError``). On the CPU the plain versions serve
    every head_dim and dtype."""
    if torch.device(device).type == "cpu":
        return
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"the paged attention kernels serve head_dim "
                         f"{HEAD_DIMS} on {device}, not {head_dim}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the paged attention kernels serve float32, "
                        f"bfloat16 and float16 on {device}, not {dtype}")


def load_kernels() -> ctypes.CDLL:
    """Build (on first use) and load the CUDA library; bind its launchers."""
    global _lib
    # analysis: allow(mutable-global-capture) — the library handle, bound
    # once (the warm-up loads it); a graph bakes in the kernels it launches
    if _lib is None:
        from ._build import library

        lib = library("paged_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        i64 = ctypes.c_longlong
        tail = [i32, i32, i32, i32, i32, i64, i64, ctypes.c_float, ptr]
        # dtype, q, k, v[, k_scale, v_scale], table, positions/prefix, out[,
        # ws, tickets, splits]
        for fn, n_ptr, decode in (
                (lib.paged_decode_attention_launch, 8, True),
                (lib.paged_prefill_attention_launch, 6, False),
                (lib.paged_decode_attention_int8_launch, 10, True),
                (lib.paged_prefill_attention_int8_launch, 8, False)):
            fn.argtypes = [i32] + [ptr] * n_ptr + [i32] * decode + tail
            fn.restype = i32
        _lib = lib
    return _lib


def decode_splits(S: int, H: int, sms: int) -> int:
    """Splits per (slot, head) of the decode grid for ``S`` slots of ``H``
    heads on a card of ``sms`` SMs: as many as keep about
    :data:`WAVE_BLOCKS` thread blocks on each SM in one wave (4 at 8 slots
    x 16 heads on 132 SMs), 1 to :data:`MAX_SPLITS`."""
    return min(max(WAVE_BLOCKS * sms // (S * H), 1), MAX_SPLITS)


@contextlib.contextmanager
def workspace_stream(stream):
    """Context in which this thread's decode launches take the workspace
    of ``stream`` (:func:`_workspace`) instead of the current stream's: a
    serving engine builds its programs under it with its replay stream,
    since the warm-up and the capture run on a side stream while the
    graph they make replays on the engine's own."""
    prev = getattr(_owner, "stream", None)
    _owner.stream = stream
    try:
        yield
    finally:
        _owner.stream = prev


def _workspace(device: torch.device, S: int, H: int, D: int):
    """The decode kernel's workspace on ``device`` for this shape and
    stream, made on first use and kept: the split count
    (:func:`decode_splits`), each split's float32 partial ``(acc[D], m,
    l)`` and ``S * H`` int32 ticket counters, zero at allocation and left
    zero by every launch. The grid and the workspace take the one split
    count decided here. Launches that share them must run in order, so
    they are keyed by the stream those launches run on: the one
    :func:`workspace_stream` names, else the current stream. Nothing is
    allocated per launch, so a decode step can be captured in a CUDA
    graph. A serving engine's warm-up makes it before any capture, and
    every graph bakes in its addresses: the engine's replay stream is
    fixed when it is built, and engines on other streams (the replicas of
    a gateway pool, each replaying on its own) never share one."""
    stream = getattr(_owner, "stream", None)
    if stream is None:
        stream = torch.cuda.current_stream(device)
    key = (device, stream.cuda_stream, S, H, D)
    # analysis: allow(mutable-global-capture) — made before any capture (the
    # warm-up launches first) and kept for the process: a graph bakes in the
    # workspace's addresses, which this table keeps alive
    if key not in _work:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        splits = decode_splits(S, H, sms)
        _work[key] = (
            torch.empty(S * H * splits * (D + 2), dtype=torch.float32,
                        device=device),
            torch.zeros(S * H, dtype=torch.int32, device=device), splits)
    return _work[key]


def _entry_scales(entry) -> tuple:
    """Check a pool entry's structure; returns its scale pools (``()`` for a
    full-precision ``(k, v)`` entry)."""
    if len(entry) == 2:
        if entry[0].dtype == torch.int8 or entry[1].dtype == torch.int8:
            raise TypeError("int8 pools need their scale pools: (k, v, "
                            "k_scale, v_scale)")
        return ()
    if len(entry) != 4:
        raise ValueError(f"pool entry must be (k, v) or (k, v, k_scale, "
                         f"v_scale), got {len(entry)} arrays")
    kp, vp, ks, vs = entry
    if kp.dtype != torch.int8 or vp.dtype != torch.int8:
        raise TypeError(f"quantized pools must be int8, got {kp.dtype}/"
                        f"{vp.dtype}")
    for t in (ks, vs):
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(kp.shape[:2]):
            raise TypeError(f"scale pools must be float32 {tuple(kp.shape[:2])}"
                            f", got {t.dtype} {tuple(t.shape)}")
    return ks, vs


def _row_stride(t, H: int, D: int) -> int:
    """Stride in elements between the ``[H, D]`` rows of ``t``, which must
    each be dense (the qkv split's views are: only their rows are strided)."""
    if tuple(t.shape[-2:]) != (H, D) or t.stride(-1) != 1 \
            or t.stride(-2) != D:
        raise ValueError(f"paged attention operand {tuple(t.shape)} "
                         f"{t.stride()}: each row's [H={H}, D={D}] must be "
                         "dense")
    return t.stride(-3)


def load_alignment(kernel: str, dtype: torch.dtype, pool_dtype: torch.dtype,
                   head_dim: int) -> int:
    """Bytes to which the CUDA kernels' loads need q's and the pools' start
    addresses and row strides aligned: 16 for the decode kernel, which
    reads every pool 16 bytes a lane, and for the prefill kernel with bf16
    queries at head_dim <= 128 (its tensor-core form gathers 16-byte pieces
    of each row with cp.async); 4 for int8 pools read a word at a time by
    the prefill's CUDA-core form; otherwise (its float32, float16 and bf16
    head_dim 256 instances) one element."""
    if kernel == "decode" or (dtype == torch.bfloat16 and head_dim <= 128):
        return 16
    return 4 if pool_dtype == torch.int8 else 1


def aligned(t, row_stride: int, nbytes: int) -> bool:
    """Whether ``t`` starts on an ``nbytes`` boundary and its rows,
    ``row_stride`` elements apart, do too."""
    return (t.data_ptr() % nbytes == 0
            and row_stride * t.element_size() % nbytes == 0)


def _launch(fn, q, kp, vp, table, scalars, bs: int, MB: int, scales=(),
            decode: bool = False):
    """Check what the CUDA kernels take, launch ``fn`` on the current
    stream and return the dense output. ``kp``/``vp`` are pools ``[NB, bs,
    H, D]`` or, for a full prefill, the chunk's own ``[sq, H, D]`` k/v;
    ``scales`` the int8 pools' dense float32 ``[NB, bs]`` scale pools;
    ``decode`` passes the decode kernel its workspace."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"paged attention takes float32, bfloat16 or "
                        f"float16, got {q.dtype}")
    pool_dtype = torch.int8 if len(scales) else q.dtype
    if kp.dtype != pool_dtype or vp.dtype != pool_dtype:
        raise TypeError(f"q {q.dtype} takes {pool_dtype} pools, got "
                        f"{kp.dtype}/{vp.dtype}")
    if not all(t.is_contiguous() for t in scales):
        raise ValueError("scale pools must be dense")
    if q.dim() != 3:
        raise ValueError(f"q must be [rows, H, D], got {tuple(q.shape)}")
    rows, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not supported; use one of {HEAD_DIMS}")
    for t in (q, kp, vp, table, scalars) + tuple(scales):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("every operand must lie on q's CUDA device")
    for t in (table, scalars):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise TypeError(f"tables, positions and prefix lengths must be "
                            f"contiguous int32, got {t.dtype}")
    q_stride = _row_stride(q, H, D)
    kv_stride = _row_stride(kp, H, D)
    if kp.shape != vp.shape or kp.stride() != vp.stride():
        raise ValueError(f"k {tuple(kp.shape)} {kp.stride()} and v "
                         f"{tuple(vp.shape)} {vp.stride()} differ")
    if kp.dim() == 4 and kp.stride(0) != bs * kv_stride:
        raise ValueError(f"pool blocks {kp.stride()} are not dense")
    nbytes = load_alignment("decode" if decode else "prefill", q.dtype,
                            kp.dtype, D)
    if not (aligned(q, q_stride, nbytes) and aligned(kp, kv_stride, nbytes)
            and aligned(vp, kv_stride, nbytes)):
        raise ValueError(f"q and the pools must start, and keep their rows, "
                         f"on {nbytes}-byte boundaries")
    out = torch.empty((rows, H, D), dtype=q.dtype, device=q.device)
    work = ()
    if decode:
        ws, tickets, splits = _workspace(q.device, rows, H, D)
        work = (ws.data_ptr(), tickets.data_ptr(), splits)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(_DTYPE_CODES[q.dtype], q.data_ptr(), kp.data_ptr(),
            vp.data_ptr(), *(t.data_ptr() for t in scales),
            table.data_ptr(), scalars.data_ptr(), out.data_ptr(),
            *work, rows, H, D, bs, MB, q_stride, kv_stride,
            1.0 / math.sqrt(D), stream)
    # rc is the launcher's host-side status (cudaGetLastError): under
    # capture it reports a refused launch once, when the graph records it
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {rc}")
    return out


def _gather_ctx(entry, table, dtype=None):
    """A block table's logical context from one pool entry: ``table``
    ``[..., max_blocks]`` int returns ``(k_all, v_all)`` shaped
    ``[..., max_blocks * block_size, heads, dim]``. An int8 entry is
    dequantized to ``dtype`` through its per-row scales, one table row
    (lane) at a time when ``dtype`` is narrower than float32, so the float32
    intermediate is one lane's context; the values are the same either way.
    The plain versions read the pools through it; its JAX counterpart is
    ``paddle_tpu/serving/engine.py:_gather_ctx``."""
    kp, vp = entry[0], entry[1]
    idx = table.long()
    if len(entry) == 4:
        ks, vs = entry[2], entry[3]
        if dtype.itemsize >= 4:
            k_all = dequantize_kv(kp[idx], ks[idx], dtype)
            v_all = dequantize_kv(vp[idx], vs[idx], dtype)
        else:
            k_all = torch.empty(idx.shape + kp.shape[1:], dtype=dtype,
                                device=kp.device)
            v_all = torch.empty_like(k_all)
            lanes = idx.reshape(-1, idx.shape[-1])
            kl = k_all.view(-1, *k_all.shape[-4:])
            vl = v_all.view(-1, *v_all.shape[-4:])
            for i, row in enumerate(lanes):
                kl[i] = dequantize_kv(kp[row], ks[row], dtype)
                vl[i] = dequantize_kv(vp[row], vs[row], dtype)
    else:
        k_all = kp[idx]
        v_all = vp[idx]  # [..., mb, bs, H, D]
    shp = k_all.shape
    out_shape = shp[:-4] + (shp[-4] * shp[-3],) + shp[-2:]
    return k_all.reshape(out_shape), v_all.reshape(out_shape)


# ------------------------------------------------------------------ decode


def paged_decode_attention(q, entry, block_tables, positions):
    """Decode attention through the block tables.

    ``q`` ``[S, H, D]`` (each slot's new token); ``entry`` one layer's
    ``(k, v)`` pools ``[num_blocks, block_size, H, D]`` or int8 ``(k, v,
    k_scale, v_scale)``; ``block_tables`` ``[S, MB]`` int32; ``positions``
    ``[S]`` int32 (the new token's write position: keys at global index
    ``<= positions[s]`` are attended). Returns ``[S, H, D]`` in
    ``q.dtype``."""
    scales = _entry_scales(entry)
    kp, vp = entry[0], entry[1]
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, entry, block_tables, positions)
    S, MB = block_tables.shape
    if q.shape[0] != S or positions.shape != (S,) or kp.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}, pools {tuple(kp.shape)}, "
                         f"tables {tuple(block_tables.shape)} and positions "
                         f"{tuple(positions.shape)} disagree")
    name = "paged_decode_attention" + ("_int8" if scales else "")
    out = _launch(getattr(load_kernels(), name + "_launch"), q, kp, vp,
                  block_tables, positions, kp.shape[1], MB, scales,
                  decode=True)
    # analysis: allow(mutable-global-capture) — a capture counts here once;
    # serving.graphs takes that back out and credits it on every replay
    launches[name] += 1
    return out


def paged_decode_attention_ref(q, entry, block_tables, positions):
    """Plain version: gather each slot's logical context, then
    ``masked_attention`` under the position mask (the JAX engine's gather
    route)."""
    t_len = block_tables.shape[1] * entry[0].shape[1]
    k_all, v_all = _gather_ctx(entry, block_tables, q.dtype)
    keys = torch.arange(t_len, device=q.device)
    mask = (keys[None, :] <= positions.long()[:, None])[:, None, None, :]
    return masked_attention(q[:, None], k_all, v_all, mask)[:, 0]


# ----------------------------------------------------------------- prefill


def _prefix_tensor(prefix_len, device: torch.device):
    """``prefix_len`` as the kernels take it: an int32 ``[1]`` tensor. A
    tensor stays where it is (``_launch`` refuses one off q's device); an
    int is filled in on the device, without a host copy."""
    if isinstance(prefix_len, torch.Tensor):
        return prefix_len.reshape(1).to(torch.int32)
    return torch.full((1,), prefix_len, dtype=torch.int32, device=device)


def paged_prefill_attention(q, entry, bt_row, prefix_len):
    """Suffix/chunk prefill attention for ONE slot through its table.

    ``q`` ``[sq, H, D]``; ``bt_row`` ``[MB]`` int32; ``prefix_len`` an int or
    an int32 device scalar: query ``i`` attends keys at global index
    ``<= prefix_len + i``. The chunk's own K/V must already be in the pools.
    ``entry`` is ``(k, v)`` or int8 ``(k, v, k_scale, v_scale)`` as for
    :func:`paged_decode_attention`. Returns ``[sq, H, D]``; padded query
    rows give finite values the caller discards."""
    scales = _entry_scales(entry)
    kp, vp = entry[0], entry[1]
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(q, entry, bt_row, prefix_len)
    if bt_row.dim() != 1 or kp.dim() != 4:
        raise ValueError(f"bt_row {tuple(bt_row.shape)} must be [MB] and the "
                         f"pools {tuple(kp.shape)} [NB, bs, H, D]")
    return _prefill(q, kp, vp, bt_row, _prefix_tensor(prefix_len, q.device),
                    kp.shape[1], scales)


def _prefill(q, kp, vp, bt_row, prefix, bs, scales=()):
    name = "paged_prefill_attention" + ("_int8" if scales else "")
    out = _launch(getattr(load_kernels(), name + "_launch"), q, kp, vp,
                  bt_row, prefix, bs, bt_row.shape[0], scales)
    # analysis: allow(mutable-global-capture) — as in paged_decode_attention:
    # credited per replay by serving.graphs
    launches[name] += 1
    return out


def paged_prefill_attention_ref(q, entry, bt_row, prefix_len):
    """Plain version: gather the slot's context, then ``masked_attention``
    under the global-position causal mask."""
    t_len = bt_row.shape[0] * entry[0].shape[1]
    k_all, v_all = _gather_ctx(entry, bt_row, q.dtype)
    gpos = torch.arange(q.shape[0], device=q.device) + prefix_len
    keys = torch.arange(t_len, device=q.device)
    mask = (keys[None, :] <= gpos[:, None])[None, None]
    return masked_attention(q[None], k_all[None], v_all[None], mask)[0]


def _pseudo_table(k, v, block_size: int):
    """View contiguous ``[sq, H, D]`` K/V as ``ceil(sq / bs)`` pseudo-blocks
    addressed by an ``arange`` table; pad keys sit above every query row."""
    sq, H, D = k.shape
    bs = int(block_size)
    nb = -(-sq // bs)
    pad = nb * bs - sq
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    entry = (k.reshape(nb, bs, H, D), v.reshape(nb, bs, H, D))
    return entry, torch.arange(nb, dtype=torch.int32, device=k.device)


def paged_full_prefill_attention(q, k, v, block_size: int):
    """Full causal prefill (no resident prefix) through the prefill kernel:
    the chunk's own ``k``/``v`` ``[sq, H, D]`` through an ``arange``
    pseudo-table at prefix 0, so query ``i`` attends keys ``<= i``. On the
    card the kernel reads ``k``/``v`` in place as ``ceil(sq / bs)``
    pseudo-blocks: it never reads a key past the last query row, so the
    ragged last block needs no padding."""
    if q.device.type == "cpu":
        return paged_full_prefill_attention_ref(q, k, v, block_size)
    if k.dim() != 3 or k.shape[0] != q.shape[0]:
        raise ValueError(f"k {tuple(k.shape)} must be [sq, H, D] like q "
                         f"{tuple(q.shape)}")
    bs = int(block_size)
    table = torch.arange(-(-k.shape[0] // bs), dtype=torch.int32,
                         device=q.device)
    return _prefill(q, k, v, table, _prefix_tensor(0, q.device), bs)


def paged_full_prefill_attention_ref(q, k, v, block_size: int):
    """Plain version of :func:`paged_full_prefill_attention`: the padded
    pseudo-blocks, then :func:`paged_prefill_attention_ref` at prefix 0."""
    entry, table = _pseudo_table(k, v, block_size)
    return paged_prefill_attention_ref(q, entry, table, 0)
