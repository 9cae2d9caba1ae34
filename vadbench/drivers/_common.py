"""What the drivers share: the program's configuration object built from
a configuration file, and the hooks that count the rows the completion
nets receive."""

from __future__ import annotations

import contextlib
import dataclasses

import torch


def model_of(config: dict) -> dict:
    """The configuration's model settings with its epochs."""
    return dict(config["model"], epochs=int(config["epochs"]))


def pipeline_config(config: dict):
    """The program's PipelineConfig for a configuration file."""
    from vec_vad_torch.config import CompletionConfig, ForegroundConfig, PipelineConfig

    names = {f.name for f in dataclasses.fields(CompletionConfig)}
    model = CompletionConfig(**{k: v for k, v in model_of(config).items() if k in names})
    fore = ForegroundConfig(patch_size=int(config["patch_size"]),
                            max_boxes_per_frame=int(config["max_boxes_per_frame"]),
                            motion_thr=float(config["motion_thr"]))
    return PipelineConfig(dataset_name=config["dataset"], fore=fore, model=model)


@contextlib.contextmanager
def completion_rows(records: dict):
    """Count, into records["rows_seen"], the cube rows every forward of a
    completion ensemble (the program's SelfCompletionNet) receives."""
    records.setdefault("rows_seen", 0)

    def pre(module, args):
        if type(module).__name__ == "SelfCompletionNet":
            x = args[0]
            records["rows_seen"] += int(x.shape[0] * (x.shape[1] if x.dim() == 5 else 1))

    handle = torch.nn.modules.module.register_module_forward_pre_hook(pre)
    try:
        yield records
    finally:
        handle.remove()


def sample(items: list, n: int, rng) -> list:
    """n entries of `items` drawn without replacement in a seeded order
    (all of them when n covers them), kept in their original order."""
    if n >= len(items):
        return list(items)
    pick = sorted(rng.choice(len(items), size=n, replace=False))
    return [items[i] for i in pick]
