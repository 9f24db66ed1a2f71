"""gim_lightglue in the port: `api.Matcher("gim_lightglue")` with the
configuration's SuperPoint and LightGlue, and, for each call the check
reads, SuperPoint's keypoints, validity and descriptors of both images
(`api.extract`, wrapped for the run) and LightGlue's partners and scores
(a forward hook on the matcher's `LightGlue`)."""

from __future__ import annotations

import functools

from benchmark.heads.gimconfig import apply_env, gim_config

KEEP_EXTRACT = ("keypoints", "valid", "descriptors")


class Program:
    name = "gim_lightglue"

    def __init__(self, cfg: dict, state_dict: dict, device, window=None):
        from gim_tpu_torch import api

        apply_env(cfg)
        self.window = window
        self.matcher = api.Matcher(self.name, gim_config(cfg),
                                   state_dict=state_dict, device=device)
        self.model = self.matcher.model
        self.kept = {}
        self._api = api
        self._extract = api.extract

        @functools.wraps(self._extract)
        def extract(*args, **kwargs):
            out = self._extract(*args, **kwargs)
            if self.window is not None and self.window.capturing:
                slot = self.kept.setdefault(self.window.index, {})
                i = sum(k.startswith("sp") for k in slot) // len(KEEP_EXTRACT)
                slot.update({f"sp{i}_{k}": out[k].cpu()
                             for k in KEEP_EXTRACT})
            return out

        api.extract = extract
        self._hook = self.model.lightglue.register_forward_hook(self._keep)

    def _keep(self, module, args, out):
        if self.window is not None and self.window.capturing:
            self.kept.setdefault(self.window.index, {}).update(
                matches0=out["matches0"].cpu(),
                scores0=out["matching_scores0"].cpu())

    def match(self, b: dict):
        return self.matcher.match(b["color0"], b["color1"], b["scale0"],
                                  b["scale1"], b["mask0"], b["mask1"])

    def counters(self) -> dict:
        return {}

    def close(self) -> None:
        self._api.extract = self._extract
        self._hook.remove()
