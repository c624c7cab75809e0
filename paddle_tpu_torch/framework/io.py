"""``paddle.save`` / ``paddle.load`` (counterpart of
``paddle_tpu/framework/io.py``).

Pickle protocol 4 of nested dicts, lists and tuples, each tensor stored as
a ``_TensorPayload`` around a numpy array (a bfloat16 tensor, which numpy
has no type for, around the CPU tensor itself). ``save`` is atomic
(``core.resilience.atomic_write``: a temp file, fsync, ``os.replace``,
retried under the IO policy with a ``ckpt_io`` probe), so a kill mid-save
leaves the previous file whole.

``load`` also reads a file that ``paddle_tpu.save`` wrote: its unpickler
maps ``paddle_tpu.framework.io._TensorPayload`` to this module's payload by
name (the JAX package is never imported), and a bfloat16 array pickled with
``ml_dtypes`` is rebuilt from its raw bits (``ml_dtypes`` need not be
installed). ``return_numpy=False`` gives CPU torch tensors;
``return_numpy=True`` numpy arrays, bfloat16 ones as float32 (exact).
Unpickle only files this program or the JAX package wrote: unpickling can
run code.

:func:`save_arrays` writes the other form the JAX package writes, that of
``jit.save``'s ``.pdparams``: a plain pickle of ``{name: ndarray}``, a
bfloat16 tensor pickled as an ``ml_dtypes.bfloat16`` array, byte for byte
what numpy and ``ml_dtypes`` would write (``ml_dtypes`` need not be
installed to write it), so ``pickle.load`` in the JAX package reads it.
"""
from __future__ import annotations

import io as _io
import pickle

import numpy as np
import torch

from ..core import resilience

__all__ = ["save", "load", "save_arrays"]


class _TensorPayload:
    __slots__ = ("array",)

    def __init__(self, array):
        self.array = array


def _to_saveable(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return _TensorPayload(t.clone() if t.dtype == torch.bfloat16
                              else t.numpy().copy())
    if isinstance(obj, dict):
        return {k: _to_saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_saveable(v) for v in obj)
    return obj


class _Bf16:
    """Stands for ``ml_dtypes.bfloat16`` inside a pickle."""


class _Bf16Dtype:
    """The dtype of a bfloat16 array being rebuilt; its pickled state is
    not needed."""

    def __setstate__(self, state):
        pass


def _np_dtype(obj, align=False, copy=False):
    if obj is _Bf16:
        return _Bf16Dtype()
    return np.dtype(obj, align, copy)


class _PickledArray:
    """An ndarray being rebuilt: a bfloat16 one from its raw bits into a
    torch tensor, any other into a numpy array."""

    __slots__ = ("value",)

    def __setstate__(self, state):
        _, shape, dtype, fortran, raw = state
        if isinstance(dtype, _Bf16Dtype):
            bits = np.frombuffer(raw, dtype="<u2").reshape(shape, order=(
                "F" if fortran else "C"))
            self.value = torch.from_numpy(bits.astype(np.int16)).view(
                torch.bfloat16)
        else:
            arr = np.ndarray.__new__(np.ndarray, (0,), np.uint8)
            arr.__setstate__(state)
            self.value = arr


def _reconstruct(subtype, shape, typecode):
    return _PickledArray()


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "_TensorPayload" and module.endswith("framework.io"):
            return _TensorPayload
        if module.startswith("ml_dtypes") and name == "bfloat16":
            return _Bf16
        if module == "numpy" and name == "dtype":
            return _np_dtype
        if (module in ("numpy._core.multiarray", "numpy.core.multiarray")
                and name == "_reconstruct"):
            return _reconstruct
        return super().find_class(module, name)


def _leaf(v, return_numpy):
    if isinstance(v, _PickledArray):
        v = v.value
    if isinstance(v, torch.Tensor):
        if return_numpy:
            return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        return v
    if return_numpy:
        return v
    return torch.from_numpy(np.ascontiguousarray(v))


def _from_saveable(obj, return_numpy=False):
    if isinstance(obj, _TensorPayload):
        return _leaf(obj.array, return_numpy)
    if isinstance(obj, _PickledArray):
        v = obj.value
        return v.float().numpy() if (return_numpy and isinstance(
            v, torch.Tensor)) else v
    if isinstance(obj, dict):
        return {k: _from_saveable(v, return_numpy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_saveable(v, return_numpy) for v in obj)
    return obj


def save(obj, path, protocol=4, **configs):
    """Pickle ``obj`` to ``path`` atomically (see the module docstring);
    the pickle streams into the temp file."""
    saveable = _to_saveable(obj)
    resilience.atomic_write(
        path, lambda f: pickle.dump(saveable, f, protocol=protocol),
        name="paddle.save")


def load(path, **configs):
    """The object ``save`` (or ``paddle_tpu.save``) wrote to ``path``:
    tensors as CPU torch tensors, or numpy arrays with
    ``return_numpy=True``."""
    return_numpy = configs.get("return_numpy", False)
    with open(path, "rb") as f:
        obj = _Unpickler(_io.BufferedReader(f)).load()
    return _from_saveable(obj, return_numpy)


class _Bf16Array:
    """A bfloat16 tensor to pickle as an ``ml_dtypes.bfloat16`` array."""

    __slots__ = ("tensor",)

    def __init__(self, tensor):
        self.tensor = tensor


_BF16_DTYPE = _Bf16Dtype()
_RECONSTRUCT = np.zeros(0).__reduce__()[0]  # numpy's _reconstruct


class _ArrayPickler(pickle._Pickler):
    """The pure-Python pickler, which lets a reduce name a class this
    process need not import: ``ml_dtypes.bfloat16`` stands as
    :class:`_Bf16`."""

    def reducer_override(self, obj):
        if isinstance(obj, _Bf16Array):
            t = obj.tensor
            raw = t.contiguous().view(torch.int16).numpy().tobytes()
            return (_RECONSTRUCT, (np.ndarray, (0,), b"b"),
                    (1, tuple(t.shape), _BF16_DTYPE, False, raw))
        if obj is _BF16_DTYPE:
            return (np.dtype, (_Bf16, False, True),
                    (3, "<", None, None, None, 2, 2, 64))
        return NotImplemented

    def save_global(self, obj, name=None):
        if obj is not _Bf16:
            return super().save_global(obj, name)
        self.save("ml_dtypes")
        self.save("bfloat16")
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def save_arrays(state, path) -> None:
    """Pickle ``{name: tensor}`` as ``{name: ndarray}`` to ``path``
    atomically (see the module docstring)."""
    arrays = {}
    for k, v in state.items():
        t = v.detach().cpu()
        arrays[k] = (_Bf16Array(t) if t.dtype == torch.bfloat16
                     else t.numpy())
    resilience.atomic_write(
        path, lambda f: _ArrayPickler(f, protocol=4).dump(arrays),
        name="jit.save")
