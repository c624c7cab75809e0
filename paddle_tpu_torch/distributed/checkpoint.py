"""Step checkpoints with manifests, retention, fallback and resume
(counterpart of ``paddle_tpu/distributed/checkpoint.py``, single process).

The JAX package writes through orbax; the port writes its own step
directories, with the same contract:

* A step is a directory ``<dir>/<step>/`` holding ``tree.pkl`` (the state's
  structure, its non-array leaves, and per array leaf its dtype, shape and
  byte range) and ``data.bin`` (every array's bytes, in order). It is
  written into a temp directory beside it, each file fsynced, then renamed
  into place (``os.replace``) and the parent fsynced: a kill mid-save
  leaves the previous step as the newest.
* Manifests: under ``FLAGS_ckpt_manifest``, ``<dir>/manifests/<step>.json``
  records each leaf's tree path (JAX's ``keystr``), shape, dtype and crc32
  (:func:`_manifest_entries`, equal to the JAX package's for the same
  arrays), the crc32s within ``FLAGS_ckpt_manifest_crc_max_bytes`` per
  save, smallest leaves first. ``restore`` verifies them and skips a
  truncated or corrupt newest step for the newest one that passes; a step
  asked for by number raises :class:`CheckpointIntegrityError` instead.
* ``async_save=True``: ``save`` copies every tensor to host memory (the
  snapshot) before it returns, so the next step's in-place update cannot
  reach the checkpoint, and one long-lived background thread writes the
  steps in order. ``wait_until_finished`` waits for them and re-raises a
  failed write.
* IO is retried under ``core.resilience.io_policy`` with a ``ckpt_io``
  probe before each attempt.

Restored arrays come back as CPU torch tensors, or, with ``target``, on
each target leaf's device.

On a mesh (the JAX package's ``_globalize``): a leaf that holds a rank's
part of a whole tensor is gathered whole before it is written: a slice
that carries a ``shard_spec`` (ZeRO's, ``distributed.sharding._place``'s)
and a tensor-parallel shard (a split parameter, or the leaf of a state
dict that shares its storage). Every rank of the mesh calls the save and
one writes: world rank 0 of the thread's training mesh (model rank 0 of a
serving mesh); a blocking save returns on every rank once the step is
written. A target leaf of either kind takes its part of the whole value
saved: a state saved whole loads onto a sharded or split target. A pipe
rank's stacked blocks (``nn.stacked``: ``blocks.<name>`` holding its
stage's rows) are gathered over the pipe group under the JAX package's
stacked names, ``[num_layers, ...]``, so a reload on one rank, or on
another pipe degree, gives each rank its own rows.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import tempfile
import time
import warnings
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core import flags, resilience
from ..core.resilience import CheckpointIntegrityError
from . import collective

__all__ = ["save_state_dict", "load_state_dict", "apply_state_dict",
           "TrainCheckpointer", "AsyncSaveHandle",
           "CheckpointIntegrityError"]

_TREE, _DATA = "tree.pkl", "data.bin"
#: what a torn or corrupt step raises while it is read or verified
_CORRUPT = (OSError, ValueError, EOFError, KeyError, IndexError,
            pickle.UnpicklingError, RuntimeError)


class _ArrayRef:
    """An array leaf inside ``tree.pkl``: where its bytes are."""

    __slots__ = ("dtype", "shape", "offset", "nbytes")

    def __init__(self, dtype, shape, offset, nbytes):
        self.dtype, self.shape = dtype, shape
        self.offset, self.nbytes = offset, nbytes


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic))


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.dtype(x.dtype))


def _flatten_with_path(tree, prefix=""):
    """``[(keystr, leaf)]`` in JAX's order: dict keys sorted, sequences by
    index, ``None`` an empty subtree; the path as ``jax.tree_util.keystr``
    writes it (``['a'][0]``)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_with_path(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten_with_path(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def _host_bytes(leaf) -> np.ndarray:
    """The leaf's bytes as a flat uint8 array (a view where the leaf is a
    contiguous CPU array)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        return t.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(leaf).reshape(-1).view(np.uint8)


def _manifest_entries(tree) -> Dict[str, dict]:
    """Per-leaf integrity record: tree path -> shape, dtype and crc32 (the
    JAX package's ``_manifest_entries``). The crc32s are taken within the
    per-save byte budget ``FLAGS_ckpt_manifest_crc_max_bytes``, smallest
    leaves first; a leaf past it records shape and dtype only, a leaf that
    is not an array its ``repr``."""
    budget = int(flags.flag("ckpt_manifest_crc_max_bytes"))
    entries: Dict[str, dict] = {}
    arrays: List[tuple] = []
    for key, leaf in _flatten_with_path(tree):
        if _is_array(leaf):
            shape = [int(s) for s in leaf.shape]
            entries[key] = {"shape": shape, "dtype": _dtype_name(leaf),
                            "crc32": None}
            nbytes = int(np.prod(shape, dtype=np.int64)
                         * (leaf.element_size() if isinstance(
                             leaf, torch.Tensor) else leaf.dtype.itemsize))
            arrays.append((nbytes, key, leaf))
        else:
            entries[key] = {"repr": repr(leaf)}
    spent = 0
    for nbytes, key, leaf in sorted(arrays, key=lambda t: t[0]):
        if spent + nbytes > budget:
            break
        spent += nbytes
        entries[key]["crc32"] = zlib.crc32(_host_bytes(leaf))
    return entries


def _manifest_mismatches(expected: Dict[str, dict], tree) -> List[str]:
    """A stored manifest against a restored tree: mismatch descriptions
    (empty: verified). A leaf without a crc32 on either side is checked by
    shape and dtype only."""
    got = _manifest_entries(tree)
    bad: List[str] = []
    missing = sorted(set(expected) - set(got))
    extra = sorted(set(got) - set(expected))
    if missing:
        bad.append(f"missing leaves {missing[:4]}")
    if extra:
        bad.append(f"unexpected leaves {extra[:4]}")
    for key, exp in expected.items():
        g = got.get(key)
        if g is None or "crc32" not in exp or "crc32" not in g:
            continue
        if exp["shape"] != g["shape"] or exp["dtype"] != g["dtype"]:
            bad.append(f"{key}: shape/dtype {g['shape']}/{g['dtype']} != "
                       f"saved {exp['shape']}/{exp['dtype']}")
        elif (exp["crc32"] is not None and g["crc32"] is not None
              and exp["crc32"] != g["crc32"]):
            bad.append(f"{key}: checksum mismatch")
    return bad


# ---------------------------------------------------------------- the files


def _splits():
    """``mp_layers.split_of`` and ``split_indices`` (imported on use: the
    parallel layers import far more than a checkpoint needs)."""
    from .fleet.meta_parallel import mp_layers

    return mp_layers.split_of, mp_layers.split_indices


def _save_mesh(tree):
    """The mesh whose ranks save ``tree`` together: the thread's training
    mesh, else the mesh of a sharded or split leaf; None for a save of one
    process."""
    from .mesh import get_hybrid_mesh

    mesh = get_hybrid_mesh()
    if mesh is not None:
        return mesh
    split_of, _ = _splits()
    found = []

    def look(x):
        if isinstance(x, torch.Tensor):
            spec = getattr(x, "shard_spec", None)
            part = split_of(x) if spec is None else None
            if spec is not None:
                found.append(spec.mesh)
            elif part is not None:
                found.append(part.split_mesh)

    _map_leaves(look, tree)
    return found[0] if found else None


def _gather_along(x, dim: int, index, whole: int, group):
    """``x`` (the entries ``index`` of ``whole`` along ``dim``) gathered
    whole over ``group``: written into a zeroed buffer and summed."""
    shape = list(x.shape)
    shape[dim] = whole
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    out.index_copy_(dim, index.to(x.device), x.detach())
    return collective.all_reduce(out, group)


def _globalize(tree):
    """Every leaf holding a rank's part of a whole tensor gathered whole (a
    collective over its group): a slice with a ``shard_spec``, a
    tensor-parallel shard (a split parameter, or a state dict's leaf of
    one, gathered by its ``split_index`` over the model group), and a pipe
    rank's stacked rows (``pipe_rows``, gathered over the pipe group after
    the model group); the others unchanged."""
    from ..nn.stacked import pipe_split_of

    split_of, split_indices = _splits()

    def leaf(x):
        if not isinstance(x, torch.Tensor):
            return x
        spec = getattr(x, "shard_spec", None)
        if spec is not None:
            return spec.gather(x.detach())
        part, rows = split_of(x), pipe_split_of(x)
        if part is not None:
            dim, _, whole = part.split_index
            x = _gather_along(x, dim, split_indices(part), whole,
                              part.split_mesh.group)
        if rows is not None:
            x = _gather_along(x, 0, torch.as_tensor(rows.pipe_rows),
                              rows.pipe_whole,
                              rows.pipe_mesh.get_group("pipe"))
        return x

    return _map_leaves(leaf, tree)


def _writer_of(mesh):
    """``(writes, group)``: whether this rank writes a save of ``mesh``
    (world rank 0 of a training mesh, model rank 0 of a serving mesh; every
    process without one) and the group that waits for it."""
    if mesh is None:
        return True, None
    if hasattr(mesh, "world"):
        return mesh.rank == 0, mesh.world
    return mesh.model_rank == 0, mesh.group


def _settle_mesh(group) -> None:
    """Every rank of a save on a mesh waits until its writer has
    written."""
    if group is not None:
        collective.barrier(group)


def _snapshot(tree):
    """A host copy of every tensor (numpy arrays copied too): what a save
    writes, whatever the caller does to its tensors afterwards."""
    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        if isinstance(x, np.ndarray):
            return x.copy()
        return x

    return _map_leaves(leaf, tree)


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_dir(path: str, tree) -> None:
    """Write ``tree`` (a snapshot) as a step directory at ``path``: into a
    temp directory beside it, fsynced, then renamed into place."""
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent,
                           prefix=f".{os.path.basename(path)}.tmp-")
    try:
        offset = 0
        with open(os.path.join(tmp, _DATA), "wb") as f:
            def put(x):
                nonlocal offset
                if not _is_array(x):
                    return x
                raw = _host_bytes(x)
                f.write(memoryview(raw))
                ref = _ArrayRef(_dtype_name(x), tuple(int(s) for s in x.shape),
                                offset, int(raw.nbytes))
                offset += int(raw.nbytes)
                return ref

            skeleton = _map_leaves(put, tree)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, _TREE), "wb") as f:
            pickle.dump({"tree": skeleton, "nbytes": offset}, f, protocol=4)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)  # then re-raised
        raise
    resilience._fsync_dir(parent)


def _read_dir(path: str, target=None):
    """The tree of a step directory: CPU tensors, or each on its target
    leaf's device. A short ``data.bin`` raises CheckpointIntegrityError."""
    with open(os.path.join(path, _TREE), "rb") as f:
        meta = pickle.load(f)
    data = os.path.join(path, _DATA)
    if os.path.getsize(data) != meta["nbytes"]:
        raise CheckpointIntegrityError(
            f"{data}: {os.path.getsize(data)} bytes, {meta['nbytes']} "
            "written (truncated)")
    with open(data, "rb") as f:
        def get(ref):
            if not isinstance(ref, _ArrayRef):
                return ref
            buf = bytearray(ref.nbytes)
            f.seek(ref.offset)
            if f.readinto(buf) != ref.nbytes:
                raise CheckpointIntegrityError(f"{data}: short read")
            dtype = getattr(torch, ref.dtype)
            if not ref.nbytes:
                return torch.empty(ref.shape, dtype=dtype)
            return torch.frombuffer(buf, dtype=torch.uint8).view(
                dtype).reshape(ref.shape)

        tree = _map_leaves(get, meta["tree"])
    if target is None:
        return tree
    return _place_like(tree, target)


def _place_like(tree, target):
    """Move each restored tensor to its target leaf's device."""
    if isinstance(tree, dict):
        return {k: _place_like(v, target.get(k) if isinstance(target, dict)
                               else None) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        tl = target if isinstance(target, (list, tuple)) else ()
        return type(tree)(_place_like(v, tl[i] if i < len(tl) else None)
                          for i, v in enumerate(tree))
    if isinstance(tree, torch.Tensor) and isinstance(target, torch.Tensor):
        spec = getattr(target, "shard_spec", None)
        if spec is not None:
            out = spec.take(tree).to(target.device)
            out.shard_spec = spec
            return out
        from ..nn.stacked import pipe_split_of

        split_of, split_indices = _splits()
        rows = pipe_split_of(target)
        if rows is not None and tree.shape[0] != target.shape[0]:
            tree = tree.index_select(0, torch.as_tensor(rows.pipe_rows))
        part = split_of(target)
        if part is not None and tree.shape != target.shape:
            return tree.index_select(part.split_index[0], split_indices(
                part)).to(target.device)
        return tree.to(target.device)
    return tree


def _io(fn, *args, name):
    def attempt():
        resilience.maybe_fault("ckpt_io")
        return fn(*args)

    return resilience.call_with_retry(attempt, name=name,
                                      policy=resilience.io_policy())


# ------------------------------------------------------- one-path state dicts


class AsyncSaveHandle:
    """An in-flight :func:`save_state_dict`: ``wait()`` blocks until it is
    committed (and re-raises its error)."""

    def __init__(self, future: Future):
        self._future = future

    def wait(self):
        self._future.result()


_writer: Optional[ThreadPoolExecutor] = None


def _get_writer() -> ThreadPoolExecutor:
    """One long-lived writer thread for :func:`save_state_dict`: saves run
    in order, so two never race onto one path."""
    global _writer
    if _writer is None:
        _writer = ThreadPoolExecutor(1, thread_name_prefix="ckpt-writer")
    return _writer


def save_state_dict(state_dict: Dict[str, Any], path: str,
                    overwrite: bool = True, blocking: bool = True):
    """Save a state dict as one directory at ``path``. When overwriting,
    the previous complete checkpoint is kept aside (``path + ".prev"``)
    until the new one commits, and :func:`load_state_dict` falls back to
    it. ``blocking=False`` takes the snapshot, then writes on the writer
    thread and returns an :class:`AsyncSaveHandle`. Sharded leaves are
    gathered whole first (see the module docstring)."""
    path = os.path.abspath(path)
    writes, group = _writer_of(_save_mesh(state_dict))
    whole = _globalize(state_dict)
    if not writes:
        if blocking:
            _settle_mesh(group)
            return None
        done: Future = Future()
        done.set_result(None)
        return AsyncSaveHandle(done)
    snap = _snapshot(whole)
    if _writer is not None:
        _writer.submit(lambda: None).result()  # settle earlier saves
    if os.path.exists(path):
        if not overwrite:
            raise FileExistsError(path)
        prev = path + ".prev"
        shutil.rmtree(prev, ignore_errors=True)
        os.replace(path, prev)

    def commit():
        _io(_write_dir, path, snap, name="ckpt.save")
        shutil.rmtree(path + ".prev", ignore_errors=True)

    if blocking:
        commit()
        _settle_mesh(group)
        return None
    return AsyncSaveHandle(_get_writer().submit(commit))


def load_state_dict(path: str, target: Optional[Dict[str, Any]] = None):
    """The state dict saved at ``path`` (or its kept-aside previous one
    when a save died before its commit); with ``target``, each tensor on
    its target leaf's device."""
    path = os.path.abspath(path)
    if not os.path.exists(path) and os.path.exists(path + ".prev"):
        path = path + ".prev"
    return _io(_read_dir, path, target, name="ckpt.restore")


def apply_state_dict(layer_or_dict, restored: Dict[str, Any]):
    """Copy restored arrays into a module's state (``state_dict()``) or a
    dict of tensors, in place, each in its own dtype and device."""
    sd = (layer_or_dict.state_dict() if hasattr(layer_or_dict, "state_dict")
          else layer_or_dict)
    with torch.no_grad():
        for k, t in sd.items():
            if k in restored and isinstance(t, torch.Tensor):
                src = restored[k]
                if not isinstance(src, torch.Tensor):
                    src = torch.as_tensor(np.asarray(src))
                t.copy_(src.to(device=t.device, dtype=t.dtype))
    return layer_or_dict


# -------------------------------------------------------- the checkpointer


class TrainCheckpointer:
    """Step-indexed checkpoints with retention and resume (see the module
    docstring). ``max_to_keep`` newest steps are kept; ``save`` writes only
    steps that are multiples of ``save_interval_steps`` unless ``force``,
    and never a step that exists or is in flight."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1, async_save: bool = True):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._manifest_dir = os.path.join(self._dir, "manifests")
        self.last_restored_step: Optional[int] = None
        self._max_to_keep = max_to_keep
        self._interval = max(1, int(save_interval_steps))
        self._async = bool(async_save)
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="ckpt-steps")
        self._pending: Dict[int, Future] = {}

    # --------------------------------------------------------------- save
    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(int(step)))

    def save(self, step: int, state_dict: Dict[str, Any],
             force: bool = False) -> bool:
        """Snapshot ``state_dict`` and write it as ``step`` (on the writer
        thread under ``async_save``). False when the step is skipped."""
        step = int(step)
        if step in self._pending or step in self.all_steps():
            return False
        if not force and step % self._interval:
            return False
        writes, group = _writer_of(_save_mesh(state_dict))
        whole = _globalize(state_dict)
        if writes:
            snap = _snapshot(whole)
            fut = self._pool.submit(self._commit, step, snap)
            self._pending[step] = fut
            resilience.bump("ckpt.saves")
            if not self._async:
                self._settle(step)
        if not self._async:
            _settle_mesh(group)
        return True

    def _commit(self, step: int, snap) -> None:
        _io(_write_dir, self._step_dir(step), snap, name="ckpt.save")
        if flags.flag("ckpt_manifest"):
            resilience.atomic_write(
                os.path.join(self._manifest_dir, f"{step}.json"),
                json.dumps({"step": step,
                            "leaves": _manifest_entries(snap)}).encode(),
                name="ckpt.manifest")
        self._retain()

    def _retain(self) -> None:
        """Delete the steps past ``max_to_keep`` and their manifests."""
        steps = self.all_steps()
        for s in steps[:max(0, len(steps) - self._max_to_keep)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
            try:
                os.remove(os.path.join(self._manifest_dir, f"{s}.json"))
            except OSError:
                pass

    def _settle(self, step: int) -> None:
        fut = self._pending.pop(step)
        fut.result()

    def wait_until_finished(self) -> None:
        """Wait for every save in flight; re-raise the first that failed."""
        first = None
        for step in sorted(self._pending):
            try:
                self._settle(step)
            except Exception as e:  # every save is settled before raising
                first = first or e
        if first is not None:
            raise first

    # ------------------------------------------------------------ restore
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        """The committed steps, oldest first."""
        return sorted(int(n) for n in os.listdir(self._dir) if n.isdigit())

    def _read_manifest(self, step: int) -> Optional[dict]:
        try:
            with open(os.path.join(self._manifest_dir, f"{step}.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _restore_verified(self, step: int, target):
        out = _io(_read_dir, self._step_dir(step), target,
                  name="ckpt.restore")
        if flags.flag("ckpt_manifest"):
            manifest = self._read_manifest(step)
            if manifest is not None:
                bad = _manifest_mismatches(manifest.get("leaves", {}), out)
                if bad:
                    raise CheckpointIntegrityError(
                        f"checkpoint step {step} failed verification: "
                        + "; ".join(bad[:5]))
        return out

    def restore(self, target: Optional[Dict[str, Any]] = None,
                step: Optional[int] = None):
        """Restore the newest valid step, or ``step``. Newest first, the
        first step that reads whole and passes its manifest wins
        (``last_restored_step``); None when no step exists; when every
        step fails, the newest one's error. An explicit ``step`` that was
        never saved raises ``ValueError``, a corrupt one
        :class:`CheckpointIntegrityError`."""
        steps = self.all_steps()
        if step is not None:
            if step not in steps:
                raise ValueError(
                    f"TrainCheckpointer.restore: step {step} was never saved "
                    f"under {self._dir}; available steps: "
                    f"{steps if steps else '(none)'}")
            out = self._restore_verified(step, target)
            self.last_restored_step = step
            return out
        first_exc: Optional[BaseException] = None
        for s in reversed(steps):
            try:
                out = self._restore_verified(s, target)
            except _CORRUPT as e:
                first_exc = first_exc or e
                resilience.bump("ckpt.invalid_steps")
                warnings.warn(f"checkpoint step {s} is invalid "
                              f"({type(e).__name__}: {e}); falling back to "
                              "the previous step")
                continue
            self.last_restored_step = s
            return out
        if first_exc is not None:
            raise first_exc
        return None

    def latest_valid_step(self) -> Optional[int]:
        """The newest step that restores whole and passes its manifest (it
        reads the data, as :meth:`restore` does)."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                tree = self.restore()
            except _CORRUPT:
                return None
        return self.last_restored_step if tree is not None else None

    # ------------------------------------------------- preemption contract
    def write_resume_marker(self, step: int, reason: str = "") -> None:
        """Record a clean preemption shutdown (``PreemptionGuard`` writes it
        after the final save committed); ``restore`` resumes with or
        without it."""
        resilience.atomic_write(
            os.path.join(self._dir, "RESUME.json"),
            json.dumps({"step": int(step), "reason": reason,
                        "time": time.time()}).encode(),
            name="ckpt.manifest")

    def resume_marker(self) -> Optional[dict]:
        try:
            with open(os.path.join(self._dir, "RESUME.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def clear_resume_marker(self) -> None:
        try:
            os.remove(os.path.join(self._dir, "RESUME.json"))
        except OSError:
            pass

    def close(self) -> None:
        """Wait for the saves in flight, then stop the writer thread."""
        try:
            self.wait_until_finished()
        finally:
            self._pool.shutdown(wait=True)
