"""Where the benchmark meets the program (``repro_torch``): the system under
test, built from the benchmark's configuration file, and the benchmark's
weights put into the program's parameter tree.

This is the only module that imports the program, and only inside its
functions.
"""

from __future__ import annotations

from typing import Any

__all__ = ["arch_config", "param_paths", "build_params", "fill", "fill_train_state", "leaf_norms",
           "leaf_copies", "build_kernels", "timer_record"]


def arch_config(conf: dict, n_layers: int):
    """The program's ``ArchConfig`` for a configuration file's ``run`` block
    at ``n_layers`` layers."""
    from repro_torch.models.config import ArchConfig, MoESettings

    run = conf["run"]
    moe = run.get("moe")
    return ArchConfig(
        name=conf["name"], family=run["family"], n_layers=int(n_layers),
        d_model=run["d_model"], n_heads=run["n_heads"], n_kv_heads=run["n_kv_heads"],
        d_ff=run["d_ff"], vocab_size=run["vocab_size"], head_dim=run["head_dim"],
        rope_theta=float(run["rope_theta"]), norm_eps=float(run["norm_eps"]),
        moe=MoESettings(n_experts=moe["n_experts"], top_k=moe["top_k"],
                        d_expert=moe["d_expert"], capacity_factor=moe["capacity_factor"])
        if moe else None,
        n_vision_patches=run.get("n_vision_patches", 0), dtype=run["dtype"],
        vocab_pad_to=run["vocab_pad_to"], sharding="tp", source=conf["source"],
        **run["program"],
    )


def param_paths(cfg) -> list[tuple[tuple, str, bool]]:
    """(path in the program's parameter tree, the benchmark's weight name,
    whether the leaf stacks the layers along its first axis), for every leaf."""
    from repro_torch.models import model as M

    out: list[tuple[tuple, str, bool]] = []
    pattern = M.decoder_pattern(cfg)
    if pattern != ("attn",):
        raise ValueError(f"the benchmark runs attention stacks only, not {pattern}")

    def walk(tree, path):
        if tree is None:
            return
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                walk(v, path + (i,))
        else:
            if path[0] == "embed":
                out.append((path, "embed", False))
            elif path[0] in ("lm_head", "final_norm"):
                out.append((path, path[0], False))
            elif path[0] == "scan":
                out.append((path, ".".join(str(k) for k in path[2:]), True))
            else:
                raise ValueError(f"unexpected parameter {path}")

    walk(M.abstract_params(cfg), ())
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def build_params(cfg, weights) -> Any:
    """A parameter tree for the program, every leaf the benchmark's weight."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.models.layers import tree_map

    params = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device=weights.device),
                      M.abstract_params(cfg))
    fill(params, cfg, weights)
    return params


def fill(params, cfg, weights) -> None:
    """Copy the benchmark's weights into the program's leaves, in place,
    layer by layer (one weight of one layer drawn at a time)."""
    import torch

    with torch.no_grad():
        for path, name, stacked in param_paths(cfg):
            leaf = _at(params, path)
            if stacked:
                for layer in range(leaf.shape[0]):
                    leaf[layer].copy_(weights.get(name, layer))
            else:
                leaf.copy_(weights.get(name))


def fill_train_state(params, opt_state, cfg, weights) -> None:
    """Put the benchmark's weights into a fresh training state: the
    parameters and the optimizer's f32 master copy (its moments are zero)."""
    import torch

    fill(params, cfg, weights)
    master = opt_state.get("master")
    if master is None:
        return
    with torch.no_grad():
        for path, _, _ in param_paths(cfg):
            _at(master, path).copy_(_at(params, path))


def _leaves(tree, cfg):
    """(benchmark leaf name, tensor, layer) of every leaf of a tree shaped as
    the parameters: a stacked leaf's layers one by one."""
    for path, name, stacked in param_paths(cfg):
        leaf = _at(tree, path)
        if stacked:
            yield from ((f"layers.{i}.{name}", leaf[i], i, name) for i in range(leaf.shape[0]))
        else:
            yield name, leaf, None, name


def leaf_copies(tree, cfg, scale: float = 1.0, skip=lambda key: False) -> dict:
    """Every benchmark leaf but those ``skip`` names, of a tree shaped as the
    parameters, times ``scale``, copied to the host in f32."""
    import torch

    with torch.no_grad():
        return {key: (x.float() * scale).cpu() for key, x, _, _ in _leaves(tree, cfg)
                if not skip(key)}


def leaf_norms(tree, cfg, scale: float = 1.0, minus=None) -> dict[str, float]:
    """The norm of every benchmark leaf (a layer's slice of a stacked leaf)
    of a tree shaped as the parameters, times ``scale``; with ``minus`` (a
    ``Weights``), the norm of the leaf less that weight, in f32."""
    import torch

    out = {}
    with torch.no_grad():
        for key, x, layer, name in _leaves(tree, cfg):
            x = x.float()
            if minus is not None:
                x = x - minus.get(name, layer, torch.float32)
            out[key] = x.norm() * scale
    keys = list(out)
    values = torch.stack([out[k] for k in keys]).tolist()
    return dict(zip(keys, values))


def build_kernels() -> None:
    """Build (first run in a checkout) or load the program's CUDA kernels."""
    from repro_torch.kernels import build

    build.build_all()


def timer_record(db) -> tuple[dict[str, tuple[float, float]], dict[str, float]]:
    """What the program's timers and counters hold now: ({timer name:
    (seconds, completed windows)} of the timer DB ``db``, {counter channel:
    total})."""
    from repro_torch.core.clocks import counter_names, counter_values

    spans = {t.name: (t.seconds(), float(t.count)) for t in db.timers()}
    names = counter_names()
    return spans, dict(zip(names, counter_values(names)))
