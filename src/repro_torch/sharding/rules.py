"""Sharding rules: map every parameter / input / cache leaf of the port to a
``Spec`` on the (pod,) data x model mesh, and a spec to DTensor placements.
The port of ``repro.sharding.rules``, on the port's own names.

Strategy (MaxText-style 2-D FSDP x TP), as the reference's:
  * weight matrices      (fsdp, model)  on (fan_in, fan_out); output
    projections (wo / w_down / w_out) are (model, fsdp) so the TP
    contraction reduces over the model axis;
  * embeddings / head    vocab on model, d_model on fsdp;
  * MoE experts          expert axis on model when divisible (expert
    parallelism), otherwise per-expert TP;
  * per-task leaves      task axis on fsdp (tasks == data-parallel groups —
    the paper's machines);
  * KV caches            batch on fsdp when divisible; otherwise the
    *sequence* dimension takes the fsdp axis (flash-decode style); kv-heads
    on model when divisible, else sequence additionally takes model;
  * every rule degrades to None when the dimension isn't divisible
    (``MeshAxes.maybe_fsdp`` / ``maybe_model``).

fsdp == ("pod", "data") in multi-pod mode, ("data",) single-pod.

The port's parameters are per layer ("layers.3.attn.wq",
``dict(model.named_parameters())``) where the reference's sit under
``stages/`` with a leading period axis ("stages/0/slot0/attn/wq", P, ...):
the rule reads the same name and trailing shape, so a port leaf's spec is
the reference's with its leading None dropped (``repro_torch.convert``
maps the names). Caches are one tuple per layer, again without the period
axis. ``Spec`` has one entry per tensor dim: None, an axis name, or a tuple
of axis names; ``placements(spec, mesh)`` turns it into the DTensor
placements of a ``DeviceMesh`` whose dim names are the axis names.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig

PyTree = Any


class Spec(tuple):
    """A partition spec: one entry per tensor dim, each None (replicated),
    a mesh axis name, or a tuple of axis names (major to minor)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "Spec(" + ", ".join(map(repr, self)) + ")"


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    fsdp: tuple[str, ...] = ("data",)
    model: str = "model"
    fsdp_size: int = 16
    model_size: int = 16

    def maybe_fsdp(self, dim: int):
        return self.fsdp if dim % self.fsdp_size == 0 else None

    def maybe_model(self, dim: int):
        return self.model if dim % self.model_size == 0 else None


_OUT_PROJ = ("wo", "w_down", "w_out")


def _leaf_spec(name: str, path: str, shape: tuple[int, ...], ax: MeshAxes) -> Spec:
    """The rule for one leaf: its last name, its "/"-joined path and its
    shape (a per-layer leaf: no period axis)."""
    nd = len(shape)
    # ---------- per-task personalization ----------
    if "/task/" in path or path.startswith("task/"):
        rest = [None] * (nd - 1)
        if nd >= 2:
            rest[-1] = ax.maybe_model(shape[-1])
        return Spec(ax.maybe_fsdp(shape[0]), *rest)
    # ---------- embeddings / head ----------
    if name == "embed":
        if nd == 3:  # audio codebooks (K, V, d)
            return Spec(None, ax.maybe_model(shape[1]), ax.maybe_fsdp(shape[2]))
        return Spec(ax.maybe_model(shape[0]), ax.maybe_fsdp(shape[1]))
    if name == "head":
        return Spec(ax.maybe_fsdp(shape[0]), ax.maybe_model(shape[1]))
    # ---------- MoE ----------
    if name == "router":
        return Spec(ax.maybe_fsdp(shape[0]), None)
    if "/moe/" in path and nd == 3:
        e, a, b = shape
        if e % ax.model_size == 0:  # expert parallelism
            return Spec(ax.model, ax.maybe_fsdp(a), None)
        # replicated experts, TP inside each expert
        if name in _OUT_PROJ:
            return Spec(None, ax.maybe_model(a), ax.maybe_fsdp(b))
        return Spec(None, ax.maybe_fsdp(a), ax.maybe_model(b))
    # ---------- MLA ----------
    if name in ("w_dkv", "w_krope", "w_uk", "w_uv"):
        return Spec(ax.maybe_fsdp(shape[0]), ax.maybe_model(shape[1]))
    # ---------- conv / small recurrent ----------
    if name == "conv_w":
        return Spec(None, ax.maybe_model(shape[1]))
    if name == "r":  # sLSTM recurrent block-diagonal (4, nh, hd, hd)
        return Spec(*([None] * nd))
    # ---------- generic projections ----------
    if nd == 2:
        if name in _OUT_PROJ:
            return Spec(ax.maybe_model(shape[0]), ax.maybe_fsdp(shape[1]))
        return Spec(ax.maybe_fsdp(shape[0]), ax.maybe_model(shape[1]))
    # ---------- vectors (norm gains, biases, A_log, ...) ----------
    return Spec(*([None] * nd))


def param_specs(cfg: ArchConfig, params: PyTree, ax: MeshAxes) -> PyTree:
    """Specs mirroring a params tree: the model's named parameters (a flat
    dict of dotted names) or a nested tree of the same leaves; tensors of
    any device, ``meta`` included."""

    def spec(path, leaf):
        pstr = path.replace(".", "/")
        return _leaf_spec(pstr.rsplit("/", 1)[-1], pstr, tuple(leaf.shape), ax)

    return tree_lib.map_with_path(spec, params)


def batch_specs(cfg: ArchConfig, batch: PyTree, ax: MeshAxes) -> PyTree:
    """The batch dim on fsdp when divisible, every other dim replicated."""

    def spec(leaf):
        b = leaf.shape[0] if leaf.ndim else 1
        return Spec(ax.maybe_fsdp(b), *([None] * (leaf.ndim - 1)))

    return tree_lib.map_(spec, batch)


def _attn_cache_spec(shape: tuple[int, ...], ax: MeshAxes, mla_mode: str = "lora") -> Spec:
    """KV cache (B, S, KVH, hd) or MLA (B, S, r)."""
    b, s = shape[0], shape[1]
    batch_ax = ax.maybe_fsdp(b)
    seq_axes: list[str] = []
    seq_shards = 1
    if batch_ax is None and s % ax.fsdp_size == 0:
        seq_axes.extend(ax.fsdp)
        seq_shards *= ax.fsdp_size
    if len(shape) == 4:
        head_ax = ax.maybe_model(shape[2])
        if head_ax is None and s % (seq_shards * ax.model_size) == 0:
            seq_axes.append(ax.model)
        return Spec(batch_ax, tuple(seq_axes) if seq_axes else None, head_ax, None)
    # MLA compressed cache (B, S, r)
    if mla_mode == "seq":
        seq_axes.append(ax.model)
        return Spec(batch_ax, tuple(seq_axes), None)
    r_ax = None if mla_mode == "replicate" else ax.maybe_model(shape[2])
    return Spec(batch_ax, tuple(seq_axes) if seq_axes else None, r_ax)


def cache_specs(cfg: ArchConfig, caches: PyTree, ax: MeshAxes) -> PyTree:
    """Specs for the serving caches (``TransformerLM.init_cache``: one
    tuple per layer). Attention caches get the flash-decode layout; SSM /
    xLSTM states shard batch (when divisible) and their widest inner dim on
    model."""
    mla_mode = ("seq" if cfg.mla_cache_seq_shard
                else "replicate" if cfg.mla_replicate_cache else "lora")

    def spec(leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        if nd >= 3 and shape[1] >= 1024:  # attention KV / MLA cache
            return _attn_cache_spec(shape, ax, mla_mode=mla_mode)
        if nd == 4:  # mamba ssm (B, nh, hd, ds) or mlstm C (B, nh, hd, hd)
            # prefer heads on model; else head_dim
            if shape[1] % ax.model_size == 0:
                return Spec(ax.maybe_fsdp(shape[0]), ax.model, None, None)
            if shape[2] % ax.model_size == 0:
                return Spec(ax.maybe_fsdp(shape[0]), None, ax.model, None)
            return Spec(ax.maybe_fsdp(shape[0]), None, None, None)
        if nd == 3:  # conv tail (B, K-1, conv_dim) or small states (B, nh, hd)
            return Spec(ax.maybe_fsdp(shape[0]), None, ax.maybe_model(shape[2]))
        if nd == 2:
            return Spec(ax.maybe_fsdp(shape[0]), None)
        return Spec(*([None] * nd))

    return tree_lib.map_(spec, caches)


def train_state_specs(cfg: ArchConfig, state, ax: MeshAxes):
    """``TrainState(params, opt_state, step)``: the optimizer's moments
    (AdamW's ``mu`` / ``nu``, SGD's momentum) mirror the params, an empty
    state stays empty, the step (a host int) takes ``Spec()``."""
    from repro_torch.train.trainer import TrainState

    opt = state.opt_state
    if isinstance(opt, tuple) and not opt:
        ospecs = ()
    elif isinstance(opt, tuple) and hasattr(opt, "_fields"):  # AdamState(mu, nu)
        ospecs = type(opt)(*(param_specs(cfg, t, ax) for t in opt))
    else:
        ospecs = param_specs(cfg, opt, ax)
    return TrainState(param_specs(cfg, state.params, ax), ospecs, Spec())


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh`` whose
    dim names are the spec's axis names): ``Shard(d)`` on each mesh dim
    that tensor dim ``d`` is split over, ``Replicate()`` on the others. A
    dim over several axes lists them major to minor, in the mesh's order,
    as JAX's ("pod", "data") does."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) if a in names else -1 for a in axes]
        if -1 in idx:
            raise ValueError(f"{spec}: axis not in the mesh's {names}")
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dim {d} lists its axes {axes} against the "
                             f"mesh's order {names}")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"{spec}: mesh axis {names[i]!r} shards two dims")
            out[i] = Shard(d)
    return tuple(out)
