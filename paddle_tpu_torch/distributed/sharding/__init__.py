"""ZeRO-sharded training of the port (counterpart of
``paddle_tpu/distributed/sharding/__init__.py``: ``group_sharded_parallel``
``:46`` with levels ``os``, ``os_g`` and ``p_g_os``,
``save_group_sharded_model``, ``GroupShardedStage2`` and
``GroupShardedStage3``).

The JAX package places the optimizer slots (and at ``p_g_os`` the
parameters) sharded over the mesh's ``sharding`` axis and XLA makes the
compiled step a ZeRO step. Here the optimizer and the model are changed in
place to do the same work by hand. A tensor is sliced by dim 0 when dim 0
divides the axis's ranks, and held whole otherwise (the JAX
``_shard_spec``); sharding rank ``k`` of ``n`` holds rows ``[k * r / n,
(k + 1) * r / n)``.

* ``os``: each rank keeps its slices of the optimizer slots, updates its
  slice of each parameter from its slice of the gradient and all-gathers
  the parameter whole.
* ``os_g``: the same, the gradients reduce-scattered over the sharding
  group first (each rank then holds only its slice).
* ``p_g_os``: the parameters too are held as slices. A forward pre-hook
  of the model gathers them whole (an autograd gather whose backward
  reduce-scatters the gradient to the slice) and its post-hook puts the
  slices back; a sublayer run again by recompute gathers its subtree's.
  The gathered tensors live as long as the graph that saved them.

As in the JAX package only the ``data`` axis splits the batch: the
sharding ranks of a data rank see the same rows, so their gradients are
equal, and the reduce-scatter takes their mean. The data group's average
(``distributed.parallel.sync_gradients``) comes first, and the global-norm
clip sums a slice's squares over the sharding group. The optimizer runs
the sharded update through its ``_shards`` hook. The optimizer's
``state_dict`` gathers its slots whole and ``set_state_dict`` takes whole
slots and keeps this rank's slices, so a ZeRO state saves whole and loads
onto any sharding; :func:`save_group_sharded_model` writes the whole model
and slots from world rank 0. ``apply_decay_param_fun`` still keys on
names. Lamb's and LARS's whole-tensor norms are not ported over slices.
"""
from __future__ import annotations

import os

import torch

from .. import collective
from ..mesh import get_hybrid_mesh

__all__ = ["group_sharded_parallel", "save_group_sharded_model",
           "GroupShardedStage2", "GroupShardedStage3", "SHARDING_AXIS",
           "ShardSpec"]

SHARDING_AXIS = "sharding"
LEVELS = ("os", "os_g", "p_g_os")


class ShardSpec:
    """Where a tensor's rows sit in its whole: rank ``mesh.axis_rank(axis)``
    of the axis holds rows ``[lo, hi)`` of ``rows``. Tensors that hold such
    a slice carry it as ``shard_spec`` (the checkpoint gathers them whole,
    and loads a whole value onto them by their rows)."""

    def __init__(self, mesh, axis: str, rows: int):
        self.mesh, self.axis, self.rows = mesh, axis, int(rows)
        n, k = mesh.axis_size(axis), mesh.axis_rank(axis)
        self.lo, self.hi = k * self.rows // n, (k + 1) * self.rows // n

    @property
    def group(self):
        return self.mesh.get_group(self.axis)

    def take(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``whole``."""
        return whole[self.lo:self.hi]

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor, from every rank's rows."""
        return collective.all_gather_rows(local.contiguous(), self.group)


def _shard_spec(t: torch.Tensor, mesh, axis: str = SHARDING_AXIS):
    """The spec of ``t``'s dim-0 slice over ``axis``, or None where it
    stays whole (one rank, a scalar, or dim 0 not divisible)."""
    n = mesh.axis_size(axis)
    if n > 1 and t.dim() >= 1 and t.shape[0] % n == 0:
        return ShardSpec(mesh, axis, t.shape[0])
    return None


def _place(t: torch.Tensor, mesh=None, axis: str = SHARDING_AXIS):
    """This rank's slice of ``t`` (a copy carrying its ``shard_spec``), or
    ``t`` where it stays whole."""
    mesh = mesh if mesh is not None else get_hybrid_mesh()
    spec = _shard_spec(t, mesh, axis)
    if spec is None:
        return t
    out = spec.take(t).clone()
    out.shard_spec = spec
    return out


class _GatherRows(torch.autograd.Function):
    """A parameter slice gathered whole; the gradient reduce-scattered back
    to the slice (the mean over the sharding ranks, whose gradients are
    equal)."""

    @staticmethod
    def forward(ctx, local, spec):
        ctx.spec = spec
        return spec.gather(local)

    @staticmethod
    def backward(ctx, g):
        n = ctx.spec.mesh.axis_size(ctx.spec.axis)
        return collective.reduce_scatter(g / n, ctx.spec.group), None


class _Stage3:
    """The gather-on-use of ``p_g_os``: ``entries`` are ``(module, name,
    param)`` for each sliced parameter, its owner and its name there.
    Every module whose subtree owns a slice gathers the slices still held
    when its forward starts and puts them back when it ends: the model's
    own forward gathers them all, and a sublayer that recompute runs again
    (its parameters read through methods as well as ``forward``) gathers
    its subtree's."""

    def __init__(self, model, entries):
        self._live = {}
        self.entries = entries
        owned = {}
        for mod, name, p in entries:
            owned.setdefault(id(mod), []).append((mod, name, p))
        for mod in model.modules():
            ents = [e for sub in mod.modules() for e in owned.get(id(sub),
                                                                  ())]
            if not ents:
                continue
            key = id(mod)
            mod.register_forward_pre_hook(
                lambda m, a, ents=ents, key=key, root=mod is model:
                self._gather(ents, key, root))
            mod.register_forward_hook(
                lambda m, a, o, key=key: self._restore(key))

    def reset(self) -> None:
        """Every slice back in its module. A recompute that stops early
        (once it has what backward needs) never runs its post-hooks, so
        the model's forward and the optimizer's step call this first."""
        self._live.clear()
        for mod, name, p in self.entries:
            mod._parameters[name] = p

    def _gather(self, entries, key, root=False):
        if root:
            self.reset()
        done = []
        for mod, name, p in entries:
            if mod._parameters.get(name) is p:
                mod._parameters[name] = _GatherRows.apply(p, p.shard_spec)
                done.append((mod, name, p))
        self._live[key] = done

    def _restore(self, key):
        for mod, name, p in self._live.pop(key, []):
            mod._parameters[name] = p


class _ZeRO:
    """The sharded update an optimizer runs through its ``_shards`` hook:
    a parameter with a spec is updated as this rank's slice, from its
    slice of the gradient, and gathered whole after; its slots are
    gathered whole by ``state_dict`` and sliced back on load."""

    def __init__(self, optimizer, mesh, level: str, axis: str):
        self.level = level
        self.group = mesh.get_group(axis)
        self.n = mesh.axis_size(axis)
        if not optimizer._elementwise:
            raise NotImplementedError(
                f"{type(optimizer).__name__} reads whole-tensor norms: its "
                "update over ZeRO slices is not ported")
        self.specs = {}
        for p in optimizer._parameter_list or []:
            spec = getattr(p, "shard_spec", None) or _shard_spec(p, mesh,
                                                                 axis)
            if spec is not None:
                self.specs[id(p)] = spec
        #: the model's gather-on-use at ``p_g_os``
        self.stage3 = None

    def local(self, p, g):
        """``(held, grad, group)``: what the update reads of ``p`` and of
        its gradient ``g``, and the group over which that gradient is
        split (None: whole)."""
        spec = self.specs.get(id(p))
        if spec is None:
            return p.detach(), g, None
        if self.level == "p_g_os":  # the gather's backward made the slice
            return p.detach(), g, self.group
        if self.level == "os":
            g = spec.take(g)
        else:
            g = collective.reduce_scatter(g / self.n, self.group)
        return spec.take(p.detach()), g, self.group

    def whole(self, p, new):
        """What ``p`` holds after its update ``new`` of its slice."""
        spec = self.specs.get(id(p))
        if spec is None or self.level == "p_g_os":
            return new
        return spec.gather(new.to(p.dtype))

    def done(self) -> None:
        if self.stage3 is not None:
            self.stage3.reset()

    def whole_state(self, opt, sd) -> dict:
        """``opt``'s state dict ``sd`` with every sliced slot gathered
        whole."""
        keys = dict(zip(map(id, opt._parameter_list or []),
                        opt._slot_keys()))
        for p in opt._parameter_list or []:
            spec = self.specs.get(id(p))
            if spec is None:
                continue
            for slot in opt._accumulators.get(id(p), {}):
                k = f"{keys[id(p)]}.{slot}"
                sd[k] = spec.gather(sd[k])
        return sd

    def local_state(self, opt, state_dict) -> dict:
        """Whole slots (a ``state_dict``) with this rank's rows of each
        sliced one."""
        sd = dict(state_dict)
        keys = dict(zip(map(id, opt._parameter_list or []),
                        opt._slot_keys()))
        for p in opt._parameter_list or []:
            spec = self.specs.get(id(p))
            if spec is None:
                continue
            prefix = f"{keys[id(p)]}."
            for k in list(sd):
                if k.startswith(prefix) and hasattr(sd[k], "shape") and \
                        len(sd[k].shape) and sd[k].shape[0] == spec.rows:
                    sd[k] = spec.take(torch.as_tensor(sd[k]))
        return sd


def _owners(model):
    """``{id(param): (module, name)}``: where each parameter is
    registered (the first place, for a shared one)."""
    out = {}
    for mod in model.modules():
        for name, p in mod._parameters.items():
            if p is not None and id(p) not in out:
                out[id(p)] = (mod, name)
    return out


def group_sharded_parallel(model, optimizer, level: str = "os_g",
                           scaler=None, group=None, offload: bool = False,
                           sync_buffers: bool = False,
                           buffer_max_size: int = 2 ** 23,
                           segment_size: int = 2 ** 20,
                           sync_comm: bool = False, dp_group=None,
                           exclude_layer=None):
    """Shard ``optimizer`` (and at ``p_g_os`` ``model``) over the thread's
    mesh's sharding axis (``group``: a mesh axis name, default
    ``"sharding"``), in place; returns ``(model, optimizer, scaler)``. One
    sharding rank changes nothing. Build it after the model is split over
    the model axis, on the optimizer of its parameters."""
    if level not in LEVELS:
        raise ValueError(f"level must be os | os_g | p_g_os, got {level!r}")
    if offload:
        raise NotImplementedError("group_sharded_parallel(offload=True) is "
                                  "not ported")
    mesh = get_hybrid_mesh()
    if mesh is None:
        raise RuntimeError("group_sharded_parallel: no training mesh on "
                           "this thread")
    axis = group if isinstance(group, str) else SHARDING_AXIS
    if mesh.axis_size(axis) <= 1:
        return model, optimizer, scaler
    if level == "p_g_os":
        owners = _owners(model)
        entries = []
        with torch.no_grad():
            for p in model.parameters():
                spec = _shard_spec(p, mesh, axis)
                if spec is None:
                    continue
                p.data = spec.take(p.data).clone()
                p.shard_spec = spec
                mod, name = owners[id(p)]
                entries.append((mod, name, p))
        model._zero_stage3 = _Stage3(model, entries)
    zero = _ZeRO(optimizer, mesh, level, axis)
    zero.stage3 = getattr(model, "_zero_stage3", None)
    optimizer._shards = zero
    optimizer._group_sharded_level = level
    return model, optimizer, scaler


def _whole_model_state(model) -> dict:
    """``model.state_dict()`` with every ``p_g_os`` slice gathered whole."""
    stage3 = getattr(model, "_zero_stage3", None)
    if stage3 is not None:
        stage3.reset()
    specs = {name: p.shard_spec for name, p in model.named_parameters()
             if getattr(p, "shard_spec", None) is not None}
    return {k: (specs[k].gather(v) if k in specs else v)
            for k, v in model.state_dict().items()}


def save_group_sharded_model(model, output: str, optimizer=None) -> None:
    """The whole model (and the optimizer's whole slots) saved to
    ``output/model.pdparams`` (``model.pdopt``) by world rank 0; every rank
    calls it (the gathers are collective) and returns once it is
    written."""
    from ...framework import io as fio

    mesh = get_hybrid_mesh()
    state = _whole_model_state(model)
    opt_state = optimizer.state_dict() if optimizer is not None else None
    if mesh is None or mesh.rank == 0:
        os.makedirs(output, exist_ok=True)
        fio.save(state, os.path.join(output, "model.pdparams"))
        if opt_state is not None:
            fio.save(opt_state, os.path.join(output, "model.pdopt"))
    if mesh is not None:
        collective.barrier(mesh.world)


class GroupShardedStage2:
    """Name-parity shim: ``group_sharded_parallel(level="os_g")`` on the
    model and optimizer; returns the model."""

    def __new__(cls, model, optimizer=None, group=None, **kw):
        group_sharded_parallel(model, optimizer, level="os_g", group=group)
        return model


class GroupShardedStage3:
    """Name-parity shim: ``group_sharded_parallel(level="p_g_os")``."""

    def __new__(cls, model, optimizer=None, group=None, **kw):
        group_sharded_parallel(model, optimizer, level="p_g_os", group=group)
        return model
