"""The sharded train step on DTensors: the model's parameters, the
optimizer's moments and the batch in the placements of the sharding rules
(``repro_torch.sharding.rules``) on a ``DeviceMesh``, and
``repro_torch.train.make_train_step`` run on them as it is, as the
reference's step runs unchanged under pjit's ``in_shardings``.

  model = TransformerLM(cfg, device=dev)
  step = make_train_step(model, opt, multitask)
  state = shard_state(model, init_state(model, opt), mesh, axes)
  run = sharded_step(model, step)
  state, metrics = run(state, shard_batch(batch, mesh, axes))

Every rank builds the same model (the same seed or the same converted
weights); ``shard_state`` replaces each parameter by a DTensor parameter in
its rule's placements, so the model's parameters, their gradients, the
AdamW moments and every in-place update stay sharded over the mesh, and
the graph mix of the per-task leaves contracts their task axis across the
data ranks (``GraphMultiTask.mix_task_params``).

Compute: the reference's FSDP x TP schedule under pjit. Inside
``sharded_step`` the forward and backward read each weight gathered over
the fsdp mesh dims only (``fsdp_gathered``: a ``redistribute`` of the
rule's fsdp entries to ``Replicate``, whose backward reduce-scatters the
gradient over fsdp alone); the model entry stays, so every product runs
tensor-parallel on model-split weights over a data-split batch, through
the model's in-forward constraints (``cfg.activation_sharding``,
``cfg.logits_sharding``, ``cfg.fsdp_gather_moe``) and its tensor-parallel
pieces (``repro_torch.sharding.tensor_parallel``: activations gathered for
column-parallel products and reduce-scattered after row-parallel ones, the
vocab-parallel embedding and loss, the MoE's shard-local dispatch). No
weight is gathered over the model axis. Tensors the forward makes for
itself (positions, masks) join as replicated (``implicit_replication``).
The scope is the dense family (``olmo_1b``, ``qwen2_5_14b``,
``qwen1_5_110b``, ``phi4_mini_3_8b``, ``multitask_lm``) and the MoE
(``mixtral_8x22b``); any other family raises ``NotImplementedError``.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from repro_torch import tree as tree_lib
from repro_torch.sharding.rules import MeshAxes, batch_specs, placements, train_state_specs


def _owner(model: nn.Module, name: str) -> tuple[nn.Module, str]:
    """The module that holds parameter ``name`` and its local name."""
    path, _, leaf = name.rpartition(".")
    return (model.get_submodule(path) if path else model), leaf


def _distribute(t: torch.Tensor, spec, mesh):
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.detach(), mesh, placements(spec, mesh))


def shard_state(model: nn.Module, state, mesh, axes: MeshAxes):
    """``state`` (``init_state(model, optimizer)``) with the model's
    parameters and the optimizer's moments in the rules' placements
    (``train_state_specs``): each parameter of the model is replaced, in
    place, by a DTensor parameter, and the returned ``TrainState`` holds
    them."""
    specs = train_state_specs(model.cfg, state, axes)
    for name, p in list(model.named_parameters()):
        owner, leaf = _owner(model, name)
        owner.register_parameter(leaf, nn.Parameter(
            _distribute(p, specs.params[name], mesh), requires_grad=p.requires_grad))
    opt = state.opt_state
    if not (isinstance(opt, tuple) and not opt):
        opt = tree_lib.map_(lambda t, s: _distribute(t, s, mesh), opt, specs.opt_state)
    return type(state)(dict(model.named_parameters()), opt, state.step)


def shard_batch(batch: dict, mesh, axes: MeshAxes) -> dict:
    """A batch of tensors on the mesh's device type as DTensors in the
    rules' placements (``batch_specs``: the batch dim on the data axis)."""
    specs = batch_specs(None, batch, axes)
    return {k: _distribute(v, specs[k], mesh) for k, v in batch.items()}


def check_tensor_parallel(cfg) -> None:
    """Raises ``NotImplementedError`` unless the model's forward runs
    tensor-parallel on DTensors: the dense and MoE attention patterns with
    GQA over token ids."""
    if not (tuple(cfg.pattern) in (("attn",), ("attn_moe",)) and not cfg.use_mla
            and cfg.input_mode == "tokens"):
        raise NotImplementedError(
            f"{cfg.name}: the tensor-parallel sharded forward covers the dense and MoE "
            "families (GQA over token ids); this family's waits (ROADMAP §1 item 3)")


@contextlib.contextmanager
def fsdp_gathered(model: nn.Module):
    """Inside, each DTensor parameter's module reads the parameter gathered
    over every mesh dim but "model" (autograd flows back to the
    sharded parameter: the gradient reduce-scatters over those dims);
    restored on exit. A parameter already whole there is read as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    held = [(*_owner(model, name), p) for name, p in model.named_parameters()
            if isinstance(p, DTensor)]
    try:
        for owner, leaf, p in held:
            names = p.device_mesh.mesh_dim_names
            want = tuple(pl if names[i] == "model" else Replicate()
                         for i, pl in enumerate(p.placements))
            if want != tuple(p.placements):
                owner._parameters[leaf] = p.redistribute(p.device_mesh, want)
        yield
    finally:
        for owner, leaf, p in held:
            owner._parameters[leaf] = p


def sharded_step(model: nn.Module, step):
    """``step`` (``make_train_step(model, ...)``, unchanged) over the
    DTensor state of ``shard_state`` and a batch of ``shard_batch``: run
    with the weights gathered over the fsdp dims (``fsdp_gathered``) and
    the forward's own tensors replicated, tensor-parallel over the "model"
    axis. The metrics come back as full (replicated) tensors; the state's
    parameters and moments stay in their placements. Raises
    ``NotImplementedError`` for a family ``check_tensor_parallel`` refuses."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    check_tensor_parallel(model.cfg)

    def run(state, batch):
        with fsdp_gathered(model), implicit_replication():
            state, metrics = step(state, batch)
        return state, {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}

    return run


def full_params(params: dict) -> dict:
    """Every parameter as a full tensor (a DTensor's ``full_tensor()``, a
    collective every rank must join), detached."""
    return {k: (v.full_tensor() if hasattr(v, "full_tensor") else v).detach()
            for k, v in params.items()}
