"""Megatron tensor parallelism of the Poser (port of
``cs_vit_tpu/parallel/tp.py``).

The JAX package shards the Poser's big matmuls over its mesh's ``model``
axis and lets GSPMD insert the collectives, so that its tensor-parallel step
is the plain global-jit step up to reduction order. The port runs one
process per card in a ``(data, model)`` grid of ``torchrun``'s ranks
(``parallel.make_mesh``) and does what GSPMD does by hand:

* :func:`param_specs` shards exactly the tensors that
  ``poser_param_specs`` shards for the same config: the weights (torch's
  rows) and biases of the column-parallel modules (``query``, ``key``,
  ``value``, ``intermediate``, ``fc1``; flax's ``P(None, "model")`` on
  ``[in, out]``), the weights (torch's columns) of the row-parallel modules
  (``proj``, ``output``, ``fc2``; their biases stay whole), each only where
  the split dimension divides. Everything else is replicated: the norms, the
  CPB MLP, ``logit_scale``, the heads, MANO, the BatchNorms.
* :func:`shard_model` turns those ``Linear`` modules into
  :class:`ColumnParallelLinear` and :class:`RowParallelLinear`, which hold
  their shard under the same names, with Megatron's operators as
  ``torch.autograd.Function``\\ s: before a column-parallel layer the
  identity forward and an all-reduce over the model group backward; after a
  row-parallel layer an all-reduce forward and the identity backward.
  Where a column-parallel layer feeds a row-parallel one through an
  elementwise function (attention heads, the GELU of an MLP, the ReLU of the
  latent group's ``MLP3``) the pair runs on the rank's share of the features
  with no collective between. Elsewhere (the perspective encoder's ``fc1``
  before a BatchNorm, its ``proj`` and ``fc2``, the angle embedders'
  ``proj``) a column-parallel layer gathers its output and a row-parallel
  layer takes its share of a whole input, which computes the same function.
* Attention splits at whole heads: a rank runs ``num_heads / n_model``
  heads at the full head width, so the sqrt(d_h) quirk keeps its scale, and
  the SwinV2 blocks cut their CPB bias and ``logit_scale`` to those heads
  after an identity-forward, all-reduce-backward operator, so that the
  replicated CPB MLP and logit scale get the grads of every head. Where the
  heads do not divide (no flagship shape: Swin-B heads 4/8/16/32, Poser
  heads 32, ``tp`` in {2, 4}), the module's sharded layers gather and
  scatter instead.
* The BatchNorms normalise over the global batch, as JAX's global step
  does: over the data group (``parallel.sync_norm``) when ``n_data > 1``;
  within a model group their input is already replicated.
* :func:`shard_optimizer` has the optimizer's global norm sum each sharded
  tensor's squares over the model group and each replicated tensor once,
  so the clip at 5.0 and the logged ``grad_norm`` are the one-process ones.

Tensor parallelism needs the eager attention path (the config's
``attention_impl="xla"``, the port's ``"eager"``), as JAX's needs its XLA
path: a hand-written kernel has no partitioning rule. ``cli.common``
configures that path for ``tp > 1``; it runs no hand-written kernel, as
JAX's TP step runs no Pallas kernel.

Weights stay in the one schema: :func:`shard_state_dict` cuts a full state
dict (what ``cli.finetune`` writes, or ``train/convert.py`` makes from flax
parameters) to a rank's shards, :func:`gather_state_dict` is its inverse,
and :func:`full_checkpoint` / :func:`restore_checkpoint` write and read the
one-process checkpoint, AdamW moments included.

Collectives that gather run as an all-reduce of a zero-padded tensor (exact:
each element is one rank's value plus zeros), which every backend takes for
tensors on any device.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..models.latent import MLP3
from ..models.modules import MHA, ContinuousAngleEmbedding, FeedForwardNetwork, Linear
from ..models.poser import PerspectiveEncoder
from ..models.swinv2 import SwinV2Block
from .mesh import Mesh
from .sync_norm import sync_batch_norms

# module paths (state-dict names without the last part) of the layers that
# poser_param_specs splits by output features (column-parallel) and by input
# features (row-parallel); the JAX names in the comments
_COL = re.compile(
    r"(^|\.)(query|key|value)$"            # query / key / value
    r"|\.intermediate\.dense$"             # intermediate (SwinV2 MLP)
    r"|\.net\.0$"                          # fc1 (FeedForwardNetwork)
    r"|^perspective_mlp\.layer\.4$"        # perspective_mlp/fc1
    r"|_linear\.0$")                       # fc1 (the latent group's MLP3)
_ROW = re.compile(
    r"\.output(\.dense)?$"                 # output (MHA, SwinV2 MLP); proj (SwinV2 attention)
    r"|\.net\.2$"                          # fc2 (FeedForwardNetwork)
    r"|^perspective_mlp\.(proj|layer\.7)$"  # perspective_mlp/proj, fc2
    r"|_linear\.2$"                        # fc2 (MLP3)
    r"|_embedder\.proj\.0$")               # proj (ContinuousAngleEmbedding)


def param_spec(name: str, shape, n_model: int) -> Optional[int]:
    """The dimension of the torch tensor `name` (of full `shape`) that is
    split over `n_model` ranks, or None where it is replicated:
    ``poser_param_specs``'s rule in torch's layout."""
    path, _, leaf = name.rpartition(".")
    if _COL.search(path):
        if (leaf == "weight" and len(shape) == 2 or leaf == "bias" and len(shape) == 1) and \
                shape[0] % n_model == 0:
            return 0
    elif _ROW.search(path) and leaf == "weight" and len(shape) == 2 and shape[1] % n_model == 0:
        return 1
    return None


def param_specs(state_dict: Mapping[str, torch.Tensor], n_model: int) -> Dict[str, Optional[int]]:
    """:func:`param_spec` of every entry of a full state dict (or of a full
    model's ``named_parameters``)."""
    return {k: param_spec(k, tuple(v.shape), n_model) for k, v in state_dict.items()}


def _cut(t: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, rank * size, size)


def shard_state_dict(full: Mapping[str, torch.Tensor], tp_rank: int, n_model: int,
                     specs: Optional[Mapping[str, Optional[int]]] = None
                     ) -> Dict[str, torch.Tensor]:
    """Model rank `tp_rank`'s entries of a full state dict (copies)."""
    specs = param_specs(full, n_model) if specs is None else specs
    out = {}
    for k, v in full.items():
        dim = specs.get(k)
        out[k] = (v if dim is None else _cut(v, dim, tp_rank, n_model)).clone()
    return out


# --- collectives ------------------------------------------------------------------------


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of `t` over `group`, in f32, back in `t`'s dtype (a new tensor)."""
    s = t.float().clone()
    dist.all_reduce(s, group=group)
    return s.to(t.dtype)


@torch.no_grad()
def gather_dim(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """The model group's shards of `t` concatenated along `dim`, in rank
    order, on every rank."""
    n = mesh.n_model
    size = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = size * n
    full = torch.zeros(shape, dtype=t.dtype, device=t.device)
    full.narrow(dim, mesh.model_rank * size, size).copy_(t)
    dist.all_reduce(full, group=mesh.model_group)
    return full


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce over the model group backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.mesh.model_group), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over the model group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        return _summed(x, mesh.model_group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """Gather the last dimension's shards forward, this rank's share of the
    grad backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.size = mesh, x.shape[-1]
        return gather_dim(x.contiguous(), x.dim() - 1, mesh)

    @staticmethod
    def backward(ctx, g):
        return _cut(g, g.dim() - 1, ctx.mesh.model_rank, ctx.mesh.n_model).contiguous(), None


class _ScatterToModel(torch.autograd.Function):
    """This rank's share of the last dimension forward, the gathered grad
    backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _cut(x, x.dim() - 1, mesh.model_rank, mesh.n_model).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g.contiguous(), g.dim() - 1, ctx.mesh), None


def copy_to_model(x, mesh):
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x, mesh):
    return _ReduceFromModel.apply(x, mesh)


class ColumnParallelLinear(Linear):
    """A ``Linear`` holding rows ``[r*out/n, (r+1)*out/n)`` of the weight and
    of the bias. Its input passes :func:`copy_to_model`; its output is this
    rank's share of the features, or the gathered whole with
    ``gather_output``."""

    mesh: Mesh = None
    gather_output = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(copy_to_model(x, self.mesh))
        return _GatherFromModel.apply(y, self.mesh) if self.gather_output else y


class RowParallelLinear(Linear):
    """A ``Linear`` holding columns ``[r*in/n, (r+1)*in/n)`` of the weight
    and the whole bias. It takes this rank's share of the input features
    (cut from a whole input unless ``input_is_parallel``), sums the partial
    products over the model group (:func:`reduce_from_model`) and adds the
    bias once."""

    mesh: Mesh = None
    input_is_parallel = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.input_is_parallel:
            x = _ScatterToModel.apply(x, self.mesh)
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        y = reduce_from_model(F.linear(x.to(dt), self.weight.to(dt)), self.mesh)
        return y if self.bias is None else y + self.bias.to(dt)


def _sites(model: nn.Module):
    """(column-parallel paths, row-parallel path, heads) of each place where
    a column-parallel layer can feed a row-parallel one elementwise; heads is
    the attention's head count (None for an MLP)."""
    for name, m in model.named_modules():
        p = f"{name}." if name else ""
        if isinstance(m, SwinV2Block):
            yield ([f"{p}attention.self.{n}" for n in ("query", "key", "value")],
                   f"{p}attention.output.dense", m.num_heads)
            yield [f"{p}intermediate.dense"], f"{p}output.dense", None
        elif isinstance(m, MHA):
            yield [f"{p}{n}" for n in ("query", "key", "value")], f"{p}output", m.num_heads
        elif isinstance(m, FeedForwardNetwork):
            yield [f"{p}net.0"], f"{p}net.2", None
        elif isinstance(m, MLP3):
            yield [f"{p}0"], f"{p}2", None
        elif isinstance(m, PerspectiveEncoder):
            yield [f"{p}layer.4"], None, None
            yield [], f"{p}proj", None
            yield [], f"{p}layer.7", None
        elif isinstance(m, ContinuousAngleEmbedding):
            yield [], f"{p}proj.0", None


def _local_heads(mesh: Mesh, heads: int):
    share = heads // mesh.n_model

    def cut(t: torch.Tensor) -> torch.Tensor:
        return copy_to_model(t, mesh)[mesh.model_rank * share:(mesh.model_rank + 1) * share]

    return cut


@torch.no_grad()
def shard_model(model: nn.Module, mesh: Mesh) -> Dict[str, Optional[int]]:
    """Shard `model` (full weights, identical on every rank of the model
    group) in place for `mesh`, and point its BatchNorms at the data group
    when ``n_data > 1``; returns the specs of its parameters. Every SwinV2
    block must run the eager attention path."""
    n = mesh.n_model
    modules = dict(model.named_modules())
    blocks = [m for m in modules.values() if isinstance(m, SwinV2Block)]
    bad = {b.attention_impl for b in blocks} - {"eager"}
    if bad:
        raise ValueError(f"tensor parallelism runs the eager attention path (attention_impl="
                         f"'eager', JAX's 'xla'); the model's blocks run {sorted(bad)}")
    specs = param_specs(dict(model.named_parameters()), n)
    sharded = {name.rpartition(".")[0] for name, d in specs.items() if d is not None}
    covered = set()
    for cols, row, heads in _sites(model):
        col_on = bool(cols) and all(c in sharded for c in cols)
        row_on = row is not None and row in sharded
        pair = col_on and row_on and (heads is None or heads % n == 0)
        for c in (c for c in cols if c in sharded):
            _to_parallel(modules[c], ColumnParallelLinear, mesh, specs, c,
                         gather_output=not pair)
            covered.add(c)
        if row_on:
            _to_parallel(modules[row], RowParallelLinear, mesh, specs, row,
                         input_is_parallel=pair)
            covered.add(row)
        if pair and heads is not None and cols[0].endswith("attention.self.query"):
            modules[cols[0].rpartition(".")[0]].local_heads = _local_heads(mesh, heads)
    if sharded - covered:
        raise AssertionError(f"sharded layers outside every known site: {sorted(sharded - covered)}")
    if mesh.n_data > 1:
        sync_batch_norms(model, mesh.data_group)
    model._tp_specs = specs
    return specs


def _to_parallel(lin: nn.Module, cls, mesh: Mesh, specs, path: str, **flags) -> None:
    for leaf in ("weight", "bias"):
        p = getattr(lin, leaf)
        dim = specs.get(f"{path}.{leaf}")
        if p is not None and dim is not None:
            setattr(lin, leaf, nn.Parameter(_cut(p.data, dim, mesh.model_rank,
                                                 mesh.n_model).clone()))
    lin.__class__ = cls
    lin.mesh = mesh
    lin.in_features, lin.out_features = lin.weight.shape[1], lin.weight.shape[0]
    for k, v in flags.items():
        setattr(lin, k, v)


def model_specs(model: nn.Module) -> Dict[str, Optional[int]]:
    """The specs :func:`shard_model` recorded (every parameter replicated
    for a model it did not shard)."""
    return getattr(model, "_tp_specs", {n: None for n, _ in model.named_parameters()})


# --- the optimizer ----------------------------------------------------------------------


def shard_optimizer(optimizer, model: nn.Module, mesh: Mesh) -> None:
    """Have ``optimizer`` (a ``train.optim.PhaseAdamW`` over `model`'s
    sharded parameters) take its global norm across the model group: which
    of its parameters hold a shard, and the group of the other shards."""
    specs, names = model_specs(model), {id(p): n for n, p in model.named_parameters()}
    optimizer.sharded = [specs.get(names[id(p)]) is not None for p in optimizer.params()]
    optimizer.model_group = mesh.model_group


def _moment_dims(optimizer, model: nn.Module, specs) -> List[Optional[int]]:
    names = {id(p): n for n, p in model.named_parameters()}
    return [specs.get(names[id(p)]) for p in optimizer.params()]


def gather_optimizer_state(optimizer, model: nn.Module, mesh: Mesh) -> Dict:
    """The optimizer's ``state_dict`` with each sharded moment gathered
    whole (every rank of the model group takes part)."""
    sd = optimizer.state_dict()
    dims = _moment_dims(optimizer, model, model_specs(model))
    state = {}
    for i, st in sd["state"].items():
        dim = dims[i]
        state[i] = {k: (gather_dim(v, dim, mesh) if dim is not None and torch.is_tensor(v)
                        and v.dim() > 0 else v) for k, v in st.items()}
    return {**sd, "state": state}


def shard_optimizer_state(sd: Mapping, optimizer, model: nn.Module, mesh: Mesh) -> Dict:
    """A one-process optimizer ``state_dict`` cut to this rank's shards."""
    dims = _moment_dims(optimizer, model, model_specs(model))
    state = {}
    for i, st in sd["state"].items():
        dim = dims[int(i)]
        state[i] = {k: (_cut(v, dim, mesh.model_rank, mesh.n_model).clone()
                        if dim is not None and torch.is_tensor(v) and v.dim() > 0 else v)
                    for k, v in st.items()}
    return {**sd, "state": state}


# --- checkpoints ------------------------------------------------------------------------


def gather_state_dict(local: Mapping[str, torch.Tensor], specs: Mapping[str, Optional[int]],
                      mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_state_dict`: every sharded entry gathered
    whole (every rank of the model group takes part)."""
    return {k: gather_dim(v, specs[k], mesh) if specs.get(k) is not None else v
            for k, v in local.items()}


def full_checkpoint(state, mesh: Mesh) -> Dict:
    """The one-process checkpoint payload of a sharded ``TrainState``
    (``train.save_checkpoint``'s keys; tensors on the CPU)."""
    model = state.model
    sd = gather_state_dict(model.state_dict(), model_specs(model), mesh)
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    opt = gather_optimizer_state(state.optimizer, model, mesh)
    opt = {**opt, "state": {i: {k: v.cpu() if torch.is_tensor(v) else v for k, v in st.items()}
                            for i, st in opt["state"].items()}}
    return {"model": sd, "merged": sd, "epoch": state.epoch, "optimizer": opt,
            "step": state.step}


def restore_checkpoint(path: str, state, mesh: Mesh) -> Dict:
    """``train.restore_checkpoint`` into a sharded ``TrainState``: the full
    model (strictly) and AdamW state, cut to this rank's shards."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model = state.model
    model.load_state_dict(shard_state_dict(payload["model"], mesh.model_rank, mesh.n_model,
                                           model_specs(model)), strict=True)
    if "optimizer" in payload:
        state.optimizer.load_state_dict(
            shard_optimizer_state(payload["optimizer"], state.optimizer, model, mesh))
    state.step = int(payload.get("step", 0))
    state.epoch = int(payload.get("epoch", 0))
    return payload
