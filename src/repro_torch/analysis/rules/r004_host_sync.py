"""R004 — no host sync inside a captured serving step.

The reference's R004 forbids Python branching on a traced value inside a
jitted function: it either fails to trace or bakes one branch into the
program and retraces whenever the host value changes (the reference's
retraces per tick).
The port's counterpart of a jitted step is a CUDA-graph capture
(``serve/step.StepExecutor``), and its hazard of the same class is a host
sync inside the captured body: ``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``bool(t)`` / ``int(t)`` / ``float(t)`` of a tensor, an
``if`` / ``while`` / conditional expression / ``assert`` on a tensor, or a
call whose output size depends on the data (``nonzero``,
``masked_select``, ``unique``, one-argument ``torch.where``). Under
capture such a sync raises; run eagerly (``cuda_graphs=False``) it stalls
every dispatch on the device; and a branch taken on one tick's value is
baked into the graph and replayed on every later tick whatever the value.

Scope: the bodies ``StepExecutor`` captures, and nothing it does not. The
rule does not infer the call graph; it keeps an explicit list,
``STEP_FUNCTIONS``, of the functions a captured step runs (the nested
functions of ``serve/step._step_bodies``, ``StepExecutor._run``, the model
methods they call and the layers, attention, recurrent, MoE and kernel
wrapper functions below them; a def nested in a listed function is in
scope too). A function added to a step's path must be added to the list.
The eager slot reset (``TransformerLM.reset_slot_state``, which reads the
host mask) and the executor's read-back run outside the graph, so they are
outside the rule's scope.

What is a tensor is inferred per function (``rules.base.tensor_names``):
parameters annotated ``torch.Tensor`` or named as the port names its id,
position and mask tensors, and names bound to ``torch.*`` / ``F.*`` calls,
tensor methods, subscripts and arithmetic. Host-level tests are exempt:
``x is None``, ``isinstance``, ``"k" in batch``, ``x.shape`` / ``ndim`` /
``dtype`` / ``device``, ``len(x)``.
"""
from __future__ import annotations

import ast

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.rules.base import (
    dotted_name,
    is_tensor_expr,
    own_nodes,
    scoped_functions,
)

# file (relative to the package) -> functions a captured serving step runs
STEP_FUNCTIONS = {
    "serve/step.py": {"_step_bodies", "StepExecutor._run"},
    "models/model.py": {
        "TransformerLM.decode_step", "TransformerLM.prefill_step", "TransformerLM._embed",
        "TransformerLM._task_rows", "TransformerLM._router_bias", "TransformerLM._ffn",
        "TransformerLM._logits", "TransformerLM._gather_adapters",
        "TransformerLM._cache_write_slab", "TransformerLM._cache_write",
        "TransformerLM._make_attend", "TransformerLM._attn_block",
        "TransformerLM._run_layers", "TransformerLM._view", "TransformerLM._constrain",
    },
    "sharding/tensor_parallel.py": {"is_dtensor", "constrain", "tp_input", "split_ready",
                                    "mean_last", "settle", "contiguous_grad", "embedding",
                                    "_lookup", "whole", "match", "cached_attention",
                                    "cache_write", "mla_cached_attention", "placed",
                                    "model_axis", "shard_ranges", "held", "rows_like", "as_rows",
                                    "weight_grad", "batch_dims", "columns_like", "on_ranks", "_wait",
                                    "_all_to_all", "_exchange_plan", "_local_at",
                                    "exchange", "swap_split", "all_gather", "all_reduce"},
    "models/attention.py": {"gqa_project", "masked_scores", "decode_attend", "cached_attend",
                            "_physical",
                            "paged_cache_write", "paged_cache_write_slab", "mla_decode",
                            "_mla_absorb", "_mla_scores", "_mla_context", "_mla_values",
                            "MLAParts.scores"},
    "models/layers.py": {"matmul", "rms_norm", "layer_norm", "nonparam_layer_norm",
                         "apply_norm", "rope_frequencies", "apply_rope", "silu", "gelu",
                         "apply_mlp", "freeze_dead_slots", "apply_task_lora"},
    "models/mamba2.py": {"dims", "_split_proj", "_causal_conv", "_softplus", "_ssd", "_recur",
                         "_vecs", "mamba2_full", "mamba2_step", "_on_heads"},
    "models/xlstm.py": {"_mlstm_update", "_mlstm_readout", "_mlstm_cell", "_root",
                        "_mlstm_qkvif", "_scan", "_chunked_scan", "_mask_if_gates", "_steps",
                        "_mlstm", "mlstm_full", "mlstm_step", "_value_block", "_key_split",
                        "_mlstm_tp", "_mlstm_decode_tp", "_slstm_scan", "slstm_full",
                        "_slstm_tp", "slstm_step", "mlstm_init_state", "slstm_init_state"},
    "models/moe.py": {"_experts", "_moe_groups", "apply_moe"},
    "kernels/runtime.py": {"pos_vector", "gather_pages", "check_kernel_inputs",
                           "check_block_table", "check_launch", "window_arg"},
    "kernels/decode_attention/ops.py": {"decode_attention", "paged_decode_attention",
                                        "_launch", "_scratch", "num_splits"},
    "kernels/prefill_attention/ops.py": {"prefill_attention", "paged_prefill_attention",
                                         "_launch", "_scratch", "_slab", "_unslab",
                                         "num_splits"},
    "kernels/decode_attention/ref.py": {"decode_attention_reference",
                                        "paged_decode_attention_reference"},
    "kernels/prefill_attention/ref.py": {"prefill_attention_reference",
                                         "paged_prefill_attention_reference"},
}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize", "nonzero",
                 "masked_select", "unique"}
_SYNC_FUNCTIONS = {"torch.nonzero", "torch.masked_select", "torch.unique",
                   "torch.cuda.synchronize"}


def _package_path(path: str) -> str | None:
    """``src/repro_torch/models/model.py`` -> ``models/model.py``."""
    p = path.replace("\\", "/")
    marker = "repro_torch/"
    return p[p.rindex(marker) + len(marker):] if marker in p else None


class HostSyncRule:
    rule_id = "R004"
    title = "host sync (.item(), bool(t), if on a tensor, ...) inside a captured step"

    def applies_to(self, path: str) -> bool:
        return _package_path(path) in STEP_FUNCTIONS

    def check(self, tree: ast.AST, source: str, path: str) -> list[Finding]:
        scope = STEP_FUNCTIONS[_package_path(path)]
        findings: dict[tuple, Finding] = {}
        for qual, fn, names in scoped_functions(tree):
            if not any(qual == s or qual.startswith(f"{s}.") for s in scope):
                continue
            for node in own_nodes(fn):
                for kind, line in self._hazards(node, names):
                    findings.setdefault((line, kind), Finding(
                        rule=self.rule_id, path=path, line=line,
                        message=(
                            f"{kind} in {qual}, which a captured serving step runs — a host "
                            "sync: it raises under CUDA-graph capture, stalls every eager "
                            "dispatch, and a branch on a tensor bakes one tick's value into "
                            "the graph (the retrace-per-tick bug class); keep it on the "
                            "device (torch.where, masks) or move it out of the step"
                        ),
                    ))
        return list(findings.values())

    @staticmethod
    def _hazards(node, names):
        if isinstance(node, ast.Call):
            name = dotted_name(node.func) or ""
            if name in _SYNC_FUNCTIONS:
                yield f"{name}()", node.lineno
            elif name == "torch.where" and len(node.args) == 1 and not node.keywords:
                yield "torch.where(cond) (the nonzero form)", node.lineno
            elif isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS \
                    and not name.startswith(("np.", "numpy.", "torch.")):
                yield f".{node.func.attr}()", node.lineno
            elif name in ("bool", "int", "float") and node.args \
                    and is_tensor_expr(node.args[0], names):
                yield f"{name}() of a tensor", node.lineno
        elif isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            if is_tensor_expr(node.test, names):
                kind = {ast.If: "if", ast.While: "while", ast.IfExp: "conditional expression",
                        ast.Assert: "assert"}[type(node)]
                yield f"`{kind}` on a tensor", node.test.lineno
