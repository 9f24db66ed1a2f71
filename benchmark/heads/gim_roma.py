"""gim_roma in the port: `api.Matcher("gim_roma")` with the configuration's
`RoMaConfig`, and for each call the check reads the dense warp and
certainty (a forward hook on the matcher's `RoMaMatcher`), the coarse
anchor logits (a forward hook on the decoder's `embedding_decoder`) and
the anchors the port picked from them (`models/roma/model.pick_anchors`,
wrapped while the program lives)."""

from __future__ import annotations

from benchmark.heads.gimconfig import apply_env, gim_config


class Program:
    name = "gim_roma"

    def __init__(self, cfg: dict, state_dict: dict, device, window=None):
        from gim_tpu_torch.api import Matcher
        from gim_tpu_torch.models.roma import model as roma_model

        apply_env(cfg)
        self.window = window
        self.matcher = Matcher(self.name, gim_config(cfg),
                               state_dict=state_dict, device=device)
        self.model = self.matcher.model
        self.kept = {}
        self._cls = self._mode = None
        self._hooks = [
            self.model.register_forward_hook(self._keep_warp),
            self.model.decoder.embedding_decoder.register_forward_hook(
                self._keep_cls)]
        self._roma = roma_model
        self._pick = roma_model.pick_anchors
        roma_model.pick_anchors = self._keep_mode

    def _capturing(self) -> bool:
        return self.window is not None and self.window.capturing

    # held on the card until the call's warp is ready, so the copies fall
    # outside the decoder's spans that the metrics read
    def _keep_cls(self, module, args, out):
        if self._capturing():
            self._cls = out[0]

    def _keep_mode(self, probs):
        mode = self._pick(probs)
        if self._capturing():
            self._mode = mode
        return mode

    def _keep_warp(self, module, args, out):
        if self._capturing():
            warp, cert = out
            cls, mode = self._cls, self._mode
            self._cls = self._mode = None
            self.kept[self.window.index] = {
                "warp": warp.cpu(), "cert": cert.cpu(), "cls": cls.cpu(),
                "anchors": mode.cpu()}

    def match(self, b: dict):
        return self.matcher.match(b["color0"], b["color1"], b["scale0"],
                                  b["scale1"], b["mask0"], b["mask1"])

    def counters(self) -> dict:
        """The port's launch counters of the kernels this head runs."""
        from gim_tpu_torch.ops.kernels import flash, refiner

        return {**refiner.LAUNCHES, **flash.LAUNCHES}

    def close(self) -> None:
        for h in self._hooks:
            h.remove()
        self._roma.pick_anchors = self._pick
