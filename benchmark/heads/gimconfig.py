"""The port's `GimConfig` from a configuration file's `gim_config`: each
group (`dkm`, `superpoint`, `lightglue`, ...) with the file's fields,
every field the file names, no other."""

from __future__ import annotations


def gim_config(cfg: dict):
    from gim_tpu_torch import config as C

    out = C.GimConfig()
    for group, fields in cfg["gim_config"].items():
        sub = getattr(out, group)
        fields = {k: tuple(v) if isinstance(v, list) else v
                  for k, v in fields.items()}
        out = C.replace(out, **{group: C.replace(sub, **fields)})
    return out


def apply_env(cfg: dict) -> None:
    """The configuration's switches (`env`), read by the port at call
    time."""
    import os

    os.environ.update({k: str(v) for k, v in cfg.get("env", {}).items()})
