"""Seeded weights and adapter iterates, made on the device from ``--seed``.

Both the program and the plain reference take their weights from here, so
neither takes anything the other made. Each layer's weights come from one
``torch.randn`` call of a generator seeded by (seed, layer), so the
reference can draw a single layer again without drawing the rest. Names are
the port's parameter names (``layers.3.attn.wq``); the reference reads them
as plain keys.

Scales: a weight is normal / sqrt(fan_in); norm gains and the per-task
leaves are normal * ``GAIN_SCALE`` / ``TASK_SCALE`` (nonzero, so that the
comparison covers the gain and bias paths too).
"""
from __future__ import annotations

import math

import torch

GAIN_SCALE = 0.1
TASK_SCALE = 0.1
_MIX = 0x9E3779B97F4A7C15


def generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator on ``device`` for one stream of one seed: any whole
    seed, negative or past 64 bits, folds into torch's seed range."""
    s = (int(seed) * _MIX + (stream + 1) * 0xBF58476D1CE4E5B9) % (2**63 - 1)
    return torch.Generator(device=device).manual_seed(s)


def draw(specs, device, seed: int, stream: int) -> dict:
    """One ``randn`` over every (name, shape, scale) of ``specs``, split
    into scaled views: {name: tensor}."""
    sizes = [math.prod(shape) for _, shape, _ in specs]
    flat = torch.randn(sum(sizes), generator=generator(device, seed, stream),
                       device=device, dtype=torch.float32)
    out, off = {}, 0
    for (name, shape, scale), n in zip(specs, sizes):
        out[name] = flat[off:off + n].view(shape).mul_(scale)
        off += n
    return out


def layer_specs(c: dict, i: int) -> list:
    d, h, kvh, hd, ff = c["d_model"], c["num_heads"], c["num_kv_heads"], c["head_dim"], c["d_ff"]
    p = f"layers.{i}."
    specs = [
        (p + "attn.wq", (d, h * hd), d ** -0.5),
        (p + "attn.wk", (d, kvh * hd), d ** -0.5),
        (p + "attn.wv", (d, kvh * hd), d ** -0.5),
        (p + "attn.wo", (h * hd, d), (h * hd) ** -0.5),
        (p + "mlp.wg", (d, ff), d ** -0.5),
        (p + "mlp.wi", (d, ff), d ** -0.5),
        (p + "mlp.wo", (ff, d), ff ** -0.5),
    ]
    if c["norm_kind"] == "rmsnorm":
        specs += [(p + "norm1.gain", (d,), GAIN_SCALE), (p + "norm2.gain", (d,), GAIN_SCALE)]
    return specs


def top_specs(c: dict) -> list:
    d, v, m = c["d_model"], c["vocab_size"], c["num_tasks"]
    specs = [("embed", (v, d), d ** -0.5)]
    if not c["tie_embeddings"]:
        specs.append(("head", (d, v), d ** -0.5))
    if c["norm_kind"] == "rmsnorm":
        specs += [("final_norm.gain", (d,), GAIN_SCALE), ("task.final_gain", (m, d), TASK_SCALE)]
    specs.append(("task.head_bias", (m, v), TASK_SCALE))
    return specs


def layer(c: dict, seed: int, i: int, device) -> dict:
    return draw(layer_specs(c, i), device, seed, 1 + i)


def top(c: dict, seed: int, device) -> dict:
    return draw(top_specs(c), device, seed, 0)


def load_into(model, c: dict, seed: int) -> None:
    """Overwrite every parameter of the port's model with this seed's
    weights, layer by layer; a parameter the draw does not name is an
    error (the model would serve weights the reference never sees)."""
    params = dict(model.named_parameters())
    seen = set()
    with torch.no_grad():
        for part in [top(c, seed, model.device)] + [
                layer(c, seed, i, model.device) for i in range(c["num_layers"])]:
            for name, t in part.items():
                params[name].copy_(t)
                seen.add(name)
            del part
    missing = sorted(set(params) - seen)
    if missing:
        raise RuntimeError(f"weights: the model has parameters the draw does not make: {missing}")


# ------------------------------------------------------------ adapters
def adapter_specs(c: dict, store: dict) -> list:
    """The first iterate of an adapter store of ``c``: per branch ("attn",
    "mlp") an (m, L, d, r) factor a and an (m, L, r, d) factor b, the
    per-task head-bias delta and, under RMSNorm, the final-gain delta."""
    m, layers, d, r, v = (c["num_tasks"], c["num_layers"], c["d_model"], store["rank"],
                          c["vocab_size"])
    specs = []
    for branch in ("attn", "mlp"):
        specs.append((f"{branch}.a", (m, layers, d, r), store["scale_a"] * d ** -0.5))
        specs.append((f"{branch}.b", (m, layers, r, d), store["scale_b"] * r ** -0.5))
    specs.append(("head_bias", (m, v), store["scale_head_bias"]))
    if c["norm_kind"] == "rmsnorm":
        specs.append(("final_gain", (m, d), store["scale_final_gain"]))
    return specs


def adapters(c: dict, store: dict, seed: int, device) -> dict:
    """{leaf name: (m, ...) tensor} of the store's first iterate."""
    return draw(adapter_specs(c, store), device, seed, 100_003)


def store_tree(flat: dict) -> dict:
    """The port's ``TaskAdapterStore`` raw layout of ``adapters`` (one
    stage, one slot: an ("attn",) model)."""
    slot = {b: {"a": flat[f"{b}.a"], "b": flat[f"{b}.b"]} for b in ("attn", "mlp")}
    task = {k: flat[k] for k in ("head_bias", "final_gain") if k in flat}
    return {"stages": [{"slot0": slot}], "task": task}


def store_flat(tree: dict, m: int) -> dict:
    """``store_tree``'s inverse over the first ``m`` rows of each leaf (a
    served tree carries a null row after the tasks'): {leaf name: (m, ...)}."""
    slot = tree["stages"][0]["slot0"]
    out = {f"{b}.{f}": slot[b][f][:m] for b in ("attn", "mlp") for f in ("a", "b")}
    out.update({k: v[:m] for k, v in tree["task"].items()})
    return out
