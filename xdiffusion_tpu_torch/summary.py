"""The startup model summary (a torchinfo-style table).

Counterpart of xdiffusion_tpu/summary.py, which renders
`flax.linen.tabulate` of the score network at depth 1. Here forward hooks on
the network's top-level modules record their input and output shapes while
the network runs one forward (no gradient) on the same example inputs:

- a DDPM-family process: its `example_batch` (x and a context of every
  signal the config names);
- EDM and consistency: (x, sigma) at ones;
- score SDE: x and a continuous `timestep` of zeros;
- a cascade: one table per stage.

Each row is a module path (as flax names it: an EDM preconditioner's
backbone modules, the tree under its `flax_param_prefix`), its type, its
input and output shapes and its parameter count, then the network's total.
Trainers print it at start-up unless `XDIFFUSION_MODEL_SUMMARY=0`; a
failure prints a line and never stops the run.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

import torch
import torch.nn as nn


EXAMPLE_BATCH = 2  # the JAX package's default


def summary_enabled() -> bool:
    return os.environ.get("XDIFFUSION_MODEL_SUMMARY", "1") not in ("0", "false")


def _shapes(value) -> str:
    if isinstance(value, torch.Tensor):
        return str(list(value.shape))
    if isinstance(value, (list, tuple)):
        return "(" + ", ".join(_shapes(v) for v in value if _shapes(v)) + ")"
    if isinstance(value, dict):
        return "{" + ", ".join(f"{k}: {_shapes(v)}" for k, v in value.items()
                               if _shapes(v)) + "}"
    return ""


def _root(net: nn.Module) -> nn.Module:
    """The module whose children are the flax tree's top level."""
    prefix = getattr(net, "flax_param_prefix", "")
    return net.get_submodule(prefix.rstrip(".")) if prefix else net


def module_rows(net: nn.Module, call) -> List[Dict[str, Any]]:
    """One forward of `call()` (which runs `net`) with hooks on the top-level
    modules: [{path, type, inputs, outputs, params}] for the root (path "")
    and each child with parameters or a forward, in registration order."""
    root = _root(net)
    rows = {"": {"path": "", "type": type(net).__name__, "inputs": "", "outputs": "",
                 "params": sum(p.numel() for p in net.parameters())}}
    for name, child in root.named_children():
        rows[name] = {"path": name, "type": type(child).__name__, "inputs": "", "outputs": "",
                      "params": sum(p.numel() for p in child.parameters())}

    def hook(name):
        def record(module, args, kwargs, output):
            if not rows[name]["outputs"]:
                rows[name].update(inputs=_shapes(list(args) + list(kwargs.values())),
                                  outputs=_shapes(output))
        return record

    handles = [net.register_forward_hook(hook(""), with_kwargs=True)]
    handles += [child.register_forward_hook(hook(name), with_kwargs=True)
                for name, child in root.named_children()]
    try:
        with torch.no_grad():
            call()
    finally:
        for handle in handles:
            handle.remove()
    return [r for r in rows.values() if r["path"] == "" or r["params"] or r["outputs"]]


def _table(rows: List[Dict[str, Any]], title: str) -> str:
    heads = ("path", "module", "inputs", "outputs", "params")
    cells = [(r["path"] or "(root)", r["type"], r["inputs"], r["outputs"], f"{r['params']:,}")
             for r in rows]
    widths = [max(len(h), *(len(c[i]) for c in cells)) for i, h in enumerate(heads)]
    line = " | ".join(h.ljust(w) for h, w in zip(heads, widths))
    out = [title, line, "-" * len(line)]
    out += [" | ".join(c.ljust(w) for c, w in zip(cell, widths)) for cell in cells]
    out.append(f"Total Parameters: {rows[0]['params']:,}")
    return "\n".join(out)


def _call(process, batch_size: int):
    """(network, a thunk running it once on the process's example inputs)."""
    from xdiffusion_tpu_torch.diffusion.consistency import GaussianDiffusion_ConsistencyModel
    from xdiffusion_tpu_torch.diffusion.edm import GaussianDiffusion_EDM

    net = process.score_network()
    device = process.device
    if isinstance(process, (GaussianDiffusion_EDM, GaussianDiffusion_ConsistencyModel)):
        data = process.config().data
        x = torch.zeros((batch_size, data.image_size, data.image_size, data.num_channels),
                        device=device)
        sigma = torch.ones((batch_size,), device=device)
        return net, lambda: net(x, sigma)
    if hasattr(process, "example_batch"):
        x, context = process.example_batch(batch_size)
        return net, lambda: net(x, context)
    data = process.config().data  # score SDE: continuous time
    x = torch.zeros((batch_size, data.image_size, data.image_size, data.num_channels),
                    device=device)
    context = {"timestep": torch.zeros((batch_size,), device=device)}
    return net, lambda: net(x, context)


def model_summary(process) -> str:
    """The table of the process's score network (one per cascade stage) at
    a batch of EXAMPLE_BATCH."""
    if "diffusion" not in process.config():  # a cascade
        return "\n".join(f"== Cascade stage {i + 1} ==\n" + model_summary(stage)
                         for i, stage in enumerate(process.models()))
    net, call = _call(process, EXAMPLE_BATCH)
    was_training = net.training
    net.eval()
    try:
        rows = module_rows(net, call)
    finally:
        net.train(was_training)
    return _table(rows, f"{type(net).__name__} summary (batch {EXAMPLE_BATCH})")


def print_model_summary(process) -> None:
    """Prints `model_summary` unless XDIFFUSION_MODEL_SUMMARY=0; a failure
    prints a line instead (the run goes on)."""
    if not summary_enabled():
        return
    try:
        print(model_summary(process), flush=True)
    except Exception as e:  # the summary is never fatal
        print(f"model summary unavailable: {e!r}", flush=True)
