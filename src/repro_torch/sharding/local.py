"""Local calls on a device mesh: the port's ``local_map``.

The model's layers are plain torch code over whole tensors. Under a mesh
(ROADMAP A7b) a layer runs per rank on local shards: its inputs are
redistributed to the layout the local code takes, the code runs on each
rank's shard, and its outputs are wrapped back as DTensors.
:class:`Local` names those layouts for one call. They are chosen by hand,
where the JAX package leaves them to GSPMD:

* an activation keeps its batch placement on the data axes ("pod",
  "data") and is replicated on "model";
* a weight is gathered on the data axes (the FSDP all-gather of its
  "embed" dim) and split on "model" only on the dim the caller names,
  where whole heads, columns or experts split evenly;
* a cache keeps the activation's batch placement, split on "model" where
  the caller names a dim.

The gradients follow from that. A weight's local gradient covers the
rank's batch shard, so it is a partial sum on every data axis the batch is
split over. A call with ``tp=True`` computes a partial sum over "model"
(a tensor-parallel product: each rank holds some heads or columns), so
every input replicated on "model" gets a partial gradient there too. The
backward of each redistribution reduce-scatters those partial gradients
back to the weight's own layout.

This is ``torch.distributed.tensor.experimental.local_map`` written out:
``DTensor.to_local(grad_placements=...)`` and ``DTensor.from_local``, whose
signatures have been stable across the torch releases the port runs on.

On plain tensors (no mesh) every layout is the identity: :meth:`Local.of`
a plain tensor hands each tensor back as it is, so the model's one body
per layer runs op for op as the unsharded code.

**Weight-stationary decode** (``REPRO_PERF_DECODE_WS``,
``models.transformer``): at decode the activation is a few rows while an
FSDP weight gather moves the layer's weights, so a layer takes its
activation with the embed dim split over "data" instead, and its
products keep each weight as laid out (:func:`stationary`): a product
that contracts the embed dim multiplies this rank's slice of the
activation (:func:`data_chunk`) by its rows of the weight and all-reduces
the activation-sized partial sums over "data" (:func:`axis_sum`); a
product whose output dim is the embed dim computes this rank's slice of
it. These run under ``no_grad`` (the serve step), so they carry no
gradient layouts.
"""

from __future__ import annotations

import contextlib
import types
from typing import Callable, Optional, Tuple

import torch

DP_AXES = ("pod", "data")
DATA_AXIS = "data"
MODEL_AXIS = "model"


def _types():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    return DTensor, Partial, Replicate, Shard


def _wait(t: torch.Tensor) -> torch.Tensor:
    """A local tensor whose collective has completed (a redistribution may
    hand back an ``AsyncCollectiveTensor``, whose storage a ctypes kernel
    launch must not read before it lands)."""
    from torch.distributed._functional_collectives import \
        AsyncCollectiveTensor
    return t.wait() if isinstance(t, AsyncCollectiveTensor) else t


def wait_local(x) -> torch.Tensor:
    """The DTensor ``x``'s local shard, its collective completed."""
    return _wait(x.to_local())


def batch_split(x) -> Tuple[bool, ...]:
    """Per mesh dim: whether the DTensor ``x`` splits its dim 0 there (a
    data axis holding a shard of the batch)."""
    _, _, _, Shard = _types()
    names = x.device_mesh.mesh_dim_names
    return tuple(n in DP_AXES and isinstance(p, Shard) and p.dim == 0
                 for n, p in zip(names, x.placements))


def axis_size(mesh, axis: str) -> int:
    """The size of ``mesh``'s axis ``axis`` (1 without one, or without a
    mesh)."""
    if mesh is None:
        return 1
    names = tuple(mesh.mesh_dim_names)
    return int(mesh.size(names.index(axis))) if axis in names else 1


def model_size(mesh) -> int:
    """The size of ``mesh``'s "model" axis (1 without one, or without a
    mesh)."""
    return axis_size(mesh, MODEL_AXIS)


class Local:
    """The layouts of one local call on ``mesh``; ``split`` is
    :func:`batch_split` of the call's activation, ``tp`` says its outputs
    are partial sums over "model". With ``mesh`` None every method hands
    its tensor back as it is."""

    def __init__(self, mesh, split: Tuple[bool, ...] = (), tp: bool = False):
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names) if mesh is not None else ()
        self.split = split
        self.tp = tp
        self.model_rank = (int(mesh.get_local_rank(MODEL_AXIS))
                           if MODEL_AXIS in self.names else 0)

    @classmethod
    def of(cls, x, tp: bool = False) -> "Local":
        """The call whose activation is ``x``: on ``x``'s mesh with its
        batch split, or the identity for a plain tensor."""
        if is_dtensor(x):
            return cls(x.device_mesh, batch_split(x), tp)
        return cls(None)

    def _placements(self, batch_dim: Optional[int], model_dim, partial_dp,
                    model_default) -> list:
        _, Partial, Replicate, Shard = _types()
        out = []
        for name, split in zip(self.names, self.split):
            if name == MODEL_AXIS:
                out.append(Shard(model_dim) if model_dim is not None
                           else model_default)
            elif split and batch_dim is not None:
                out.append(Shard(batch_dim))
            elif split and partial_dp:
                out.append(Partial())
            else:
                out.append(Replicate())
        return out

    def _model_grad(self):
        _, Partial, Replicate, _ = _types()
        return Partial() if self.tp else Replicate()

    @staticmethod
    def _local(x, placements, grad):
        if tuple(x.placements) != tuple(placements):
            x = x.redistribute(x.device_mesh, placements)
        return _wait(x.to_local(grad_placements=grad))

    def act(self, x, batch_dim: int = 0,
            model_dim: Optional[int] = None) -> torch.Tensor:
        """An activation's local shard: its batch split as the call's,
        replicated on "model" (or split there along ``model_dim``: the
        experts of an expert-parallel call)."""
        if self.mesh is None:
            return x
        _, _, Replicate, _ = _types()
        want = self._placements(batch_dim, model_dim, False, Replicate())
        grad = self._placements(batch_dim, model_dim, False,
                                self._model_grad())
        return self._local(x, want, grad)

    def param(self, w, model_dim: Optional[int] = None) -> torch.Tensor:
        """A weight gathered on the data axes, split on "model" along
        ``model_dim`` (None: replicated). Within
        :func:`unreduced_data_grads`, a weight already replicated on the
        data axes keeps its gradient a partial sum there."""
        if self.mesh is None:
            return w
        _, _, Replicate, Shard = _types()
        want = self._placements(None, model_dim, False, Replicate())
        grad = self._placements(None, model_dim, True, self._model_grad())
        if _grads.unreduced and tuple(w.placements) != tuple(want):
            w = _Relayout.apply(w, tuple(want))
        return self._local(w, want, grad)

    def state(self, c, model_dim: Optional[int] = None,
              batch_dim: int = 0) -> Tuple[torch.Tensor, Callable]:
        """A cache entry's local shard for in-place updates, and the call
        that lands those updates in ``c``: a no-op where ``c`` is already
        laid out so (the shard is a view of its storage), else a copy back
        from the gathered layout."""
        if self.mesh is None:
            return c, lambda: None
        _, _, Replicate, _ = _types()
        want = self._placements(batch_dim, model_dim, False, Replicate())
        if tuple(c.placements) == tuple(want):
            return _wait(c.to_local()), lambda: None
        local = _wait(c.redistribute(c.device_mesh, want).to_local())

        def write_back():
            c.copy_(self.wrap(local, want).redistribute(c.device_mesh,
                                                        c.placements))
        return local, write_back

    def out(self, t: torch.Tensor, batch_dim: int = 0,
            model_dim: Optional[int] = None):
        """A local result as a DTensor: the call's batch split, and on
        "model" a shard along ``model_dim``, a partial sum (``tp``) or
        replicated."""
        if self.mesh is None:
            return t
        _, Partial, Replicate, _ = _types()
        placements = self._placements(
            batch_dim, model_dim, False,
            Partial() if self.tp else Replicate())
        return self.wrap(t, placements)

    def wrap(self, t: torch.Tensor, placements):
        if self.mesh is None:
            return t
        DTensor, _, _, _ = _types()
        return DTensor.from_local(t, self.mesh, placements, run_check=False)

    def total(self, t: torch.Tensor) -> torch.Tensor:
        """A rank's sum over its batch shard as the sum over the batch (a
        plain tensor, the same on every rank)."""
        if self.mesh is None:
            return t
        _, Partial, Replicate, _ = _types()
        placements = [Partial() if s else Replicate() for s in self.split]
        return replicated(self.wrap(t, placements)).to_local()


#: whether weight gradients stay unreduced on the data axes
#: (:func:`unreduced_data_grads`); process-wide, as the autograd engine runs
#: a CUDA backward (and remat's recompute in it) on its own device threads
_grads = types.SimpleNamespace(unreduced=False)


@contextlib.contextmanager
def unreduced_data_grads():
    """Within the block, :meth:`Local.param` keeps the gradient of a weight
    that is replicated on the data axes a partial sum there (DTensor
    ``Partial``) through its relayout on the other axes, instead of
    all-reducing it, as DTensor's own backward of that relayout does: the
    train step's deferred gradient sync (``REPRO_PERF_DEFER_GRAD_SYNC``)
    sums the microbatches' partial gradients locally and reduces once."""
    prev = _grads.unreduced
    _grads.unreduced = True
    try:
        yield
    finally:
        _grads.unreduced = prev


class _Relayout(torch.autograd.Function):
    """A DTensor redistributed to ``placements``; its backward brings the
    gradient back to the input's placements except on a data axis where
    the input is replicated and the gradient is a partial sum: there it
    stays partial."""

    @staticmethod
    def forward(ctx, w, placements):
        ctx.mesh, ctx.placements = w.device_mesh, tuple(w.placements)
        return w.redistribute(w.device_mesh, list(placements))

    @staticmethod
    def backward(ctx, grad):
        names = ctx.mesh.mesh_dim_names
        want = [g if (n in DP_AXES and g.is_partial() and p.is_replicate())
                else p for n, g, p in zip(names, grad.placements,
                                          ctx.placements)]
        return grad.redistribute(ctx.mesh, want), None


def replicated(x):
    """The DTensor ``x`` replicated on every mesh dim (a plain tensor as it
    is)."""
    if not is_dtensor(x):
        return x
    _, _, Replicate, _ = _types()
    return x.redistribute(x.device_mesh,
                          [Replicate()] * x.device_mesh.ndim)


def residual(x, out):
    """``x + out``, with the DTensor ``out`` (a partial sum or replicated
    on "model") first brought to ``x``'s layout."""
    if is_dtensor(out):
        out = out.redistribute(x.device_mesh, x.placements)
    return x + out


def is_dtensor(x) -> bool:
    return isinstance(x, _types()[0])


def mesh_of(x):
    """The mesh of the DTensor ``x``; None for a plain tensor."""
    return x.device_mesh if is_dtensor(x) else None


def layout_batch(batch: dict, mesh) -> dict:
    """The batch's tensors as DTensors laid out by the batch spec (dim 0
    over the data axes where it divides); a DTensor is left as it is, a
    plain tensor must be the same on every rank. Without a mesh the batch
    as it is."""
    if mesh is None:
        return batch
    from torch.distributed.tensor import distribute_tensor

    from ..models.schema import placements_for
    from .rules import batch_pspec
    out = {}
    for name, t in batch.items():
        if torch.is_tensor(t) and not is_dtensor(t):
            spec = (batch_pspec(mesh, t.shape[0])[0],) + \
                (None,) * (t.dim() - 1)
            t = distribute_tensor(t, mesh, list(placements_for(spec, mesh)))
        out[name] = t
    return out


# ------------------------------------------------ weight-stationary decode --
def _on_axes(mesh, **by_axis) -> list:
    """One placement per mesh dim: ``by_axis[name]`` where given, else
    ``Replicate()``."""
    _, _, Replicate, _ = _types()
    return [by_axis.get(n, Replicate()) for n in mesh.mesh_dim_names]


def fsdp_split(w) -> bool:
    """Whether the DTensor ``w`` is split over a "data" axis of size > 1
    (an FSDP-laid-out weight), so a weight-stationary product applies."""
    _, _, _, Shard = _types()
    if not is_dtensor(w) or axis_size(w.device_mesh, DATA_AXIS) < 2:
        return False
    names = tuple(w.device_mesh.mesh_dim_names)
    return isinstance(w.placements[names.index(DATA_AXIS)], Shard)


def stationary(w, model_dim: Optional[int] = None) -> torch.Tensor:
    """The weight ``w``'s local shard as it is laid out on "data" (its
    FSDP split kept: nothing is gathered there), split on "model" along
    ``model_dim`` (None: replicated) and replicated on any other axis."""
    _, _, Replicate, Shard = _types()
    names = tuple(w.device_mesh.mesh_dim_names)
    model = Shard(model_dim) if model_dim is not None else Replicate()
    want = _on_axes(w.device_mesh, **{DATA_AXIS: w.placements[
        names.index(DATA_AXIS)], MODEL_AXIS: model})
    if tuple(w.placements) != tuple(want):
        w = w.redistribute(w.device_mesh, want)
    return _wait(w.to_local())


def data_chunk(t: torch.Tensor, mesh, dim: int = -1) -> torch.Tensor:
    """This rank's chunk of ``t`` along ``dim`` by its "data" coordinate
    (the chunk a ``Shard(dim)`` over "data" holds)."""
    n = axis_size(mesh, DATA_AXIS)
    size = t.shape[dim] // n
    return t.narrow(dim, int(mesh.get_local_rank(DATA_AXIS)) * size, size)


def axis_sum(t: torch.Tensor, mesh, axis: str = DATA_AXIS) -> torch.Tensor:
    """Each rank's partial sum ``t`` summed over the mesh axis ``axis`` (an
    all-reduce), on every rank."""
    DTensor, Partial, Replicate, _ = _types()
    d = DTensor.from_local(t, mesh, _on_axes(mesh, **{axis: Partial()}),
                           run_check=False)
    return _wait(d.redistribute(mesh, _on_axes(mesh)).to_local())


def axis_gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """The local shards ``t`` of a tensor split along ``dim`` over the mesh
    axis ``axis``, gathered whole (an all-gather), on every rank."""
    DTensor, _, _, Shard = _types()
    d = DTensor.from_local(t, mesh, _on_axes(mesh, **{axis: Shard(dim)}),
                           run_check=False)
    return _wait(d.redistribute(mesh, _on_axes(mesh)).to_local())


def embed_sharded(t: torch.Tensor, mesh, partial_model: bool = False):
    """A local slice of an activation's embed (last) dim as the DTensor
    split there over "data", a partial sum over "model" when
    ``partial_model`` (else replicated there)."""
    DTensor, Partial, _, Shard = _types()
    by_axis = {DATA_AXIS: Shard(t.dim() - 1)}
    if partial_model:
        by_axis[MODEL_AXIS] = Partial()
    return DTensor.from_local(t, mesh, _on_axes(mesh, **by_axis),
                              run_check=False)
