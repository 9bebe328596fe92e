"""Adam with L2 weight decay added to the gradient (torch.optim.Adam's
update, eps outside the square root), written out in float32."""

import torch


class Adam:
    def __init__(self, params: dict, lr: float, weight_decay: float = 0.0, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = params
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """Updates the parameters in place; returns the gradients the moments took (with the decay)."""
        self.t += 1
        b1, b2 = self.betas
        taken = {}
        for k, p in self.params.items():
            g = grads[k] + self.wd * p if self.wd else grads[k]
            taken[k] = g
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k] / (1 - b2**self.t)).sqrt() + self.eps
            p.sub_(self.lr / (1 - b1**self.t) * self.m[k] / denom)
        return taken


def make(params: dict, learning_rate: float = 1e-3, weight_decay: float = 0.0, betas=(0.9, 0.999),
         eps: float = 1e-8) -> Adam:
    return Adam(params, learning_rate, weight_decay, tuple(betas), eps)
