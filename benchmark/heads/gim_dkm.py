"""gim_dkm in the port: `api.Matcher("gim_dkm")` with the configuration's
`DKMConfig`, and the dense warp and certainty of each call the check
reads (a forward hook on the matcher's `DKMMatcher`)."""

from __future__ import annotations

from benchmark.heads.gimconfig import apply_env, gim_config


class Program:
    name = "gim_dkm"

    def __init__(self, cfg: dict, state_dict: dict, device, window=None):
        from gim_tpu_torch.api import Matcher

        apply_env(cfg)
        self.window = window
        self.matcher = Matcher(self.name, gim_config(cfg),
                               state_dict=state_dict, device=device)
        self.model = self.matcher.model
        self.kept = {}
        self._hook = self.model.register_forward_hook(self._keep)

    def _keep(self, module, args, out):
        if self.window is not None and self.window.capturing:
            warp, cert = out
            self.kept[self.window.index] = {"warp": warp.cpu(),
                                            "cert": cert.cpu()}

    def match(self, b: dict):
        return self.matcher.match(b["color0"], b["color1"], b["scale0"],
                                  b["scale1"], b["mask0"], b["mask1"])

    def counters(self) -> dict:
        """The port's launch counters of the kernels this head runs."""
        from gim_tpu_torch.ops.kernels import refiner

        return dict(refiner.LAUNCHES)

    def close(self) -> None:
        self._hook.remove()
