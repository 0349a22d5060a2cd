"""Adam with low-precision moment storage (counterpart of
txt2vid_tpu/ops/optim.py:28-68 and of optax.adam's `mu_dtype`).

`AdamStorage` keeps each moment in its own storage dtype (mu_dtype, nu_dtype;
None = the parameter's) and does all its arithmetic in float32, in optax's
order: the stored moments are read and upcast, updated (b1 * mu + (1 - b1) *
g, b2 * nu + (1 - b2) * g^2), the update is taken from the float32 moments,
(mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) scaled by -lr and added to
the parameter, and only then are the moments stored, rounded to nearest even.
The count t is incremented before the bias corrections (optim.py:44-55).
One exception is optax.adam's own: with mu_dtype and no nu_dtype it forms
b1 * mu with b1 rounded to mu's dtype (jnp's weak-type rule; jitted, the
product itself is kept in float32), and so does AdamStorage there; at the
CLI's b1 = 0.5 nothing is rounded.

`--bf16` alone is optax.adam(mu_dtype=bf16), `--bf16_nu` adam_storage(nu_dtype
=bf16) with or without it: both are this optimizer. Its state holds torch
Adam's keys ("step", "exp_avg", "exp_avg_sq"), so convert.py maps it onto
optax's ScaleByAdamState (count, mu, nu) as it maps torch.optim.Adam's, the
moments in their storage dtype. torch.optim.Adam stays the float32 path.
"""

import torch


class AdamStorage(torch.optim.Optimizer):
    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, mu_dtype=None, nu_dtype=None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      mu_dtype=mu_dtype, nu_dtype=nu_dtype))
        self._flats = {}

    @staticmethod
    def storage_dtype(group, p, key):
        """The dtype `key` ("exp_avg" or "exp_avg_sq") of `p` is stored in."""
        dtype = group["mu_dtype" if key == "exp_avg" else "nu_dtype"]
        return dtype or p.dtype

    def _flat(self, index, params, key):
        """Group `index`'s `key` moments as one flat buffer in their storage
        dtype, each parameter's state tensor a view of it, so that an update
        is a few kernels and not a few per parameter. Rebuilt from the state
        tensors when they are not its views (a restore replaced them)."""
        views = [self.state[p][key] for p in params]
        flat, ids = self._flats.get((index, key), (None, None))
        if flat is None or ids != [id(p) for p in params] or any(
                v.untyped_storage().data_ptr() != flat.untyped_storage().data_ptr()
                for v in views):
            flat = torch.cat([v.reshape(-1) for v in views])
            offset = 0
            for p, v in zip(params, views):
                self.state[p][key] = flat[offset:offset + v.numel()].view_as(v)
                offset += v.numel()
            self._flats[index, key] = flat, [id(p) for p in params]
        return flat

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        f32 = torch.float32
        for index, group in enumerate(self.param_groups):
            b1, b2, eps, lr = group["b1"], group["b2"], group["eps"], group["lr"]
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=f32)
                    for key in ("exp_avg", "exp_avg_sq"):
                        st[key] = torch.zeros_like(p, dtype=self.storage_dtype(group, p, key))
            mu_store = self._flat(index, params, "exp_avg")
            nu_store = self._flat(index, params, "exp_avg_sq")
            g = torch.cat([p.grad.reshape(-1) for p in params]).to(f32)
            b1_mu = b1
            if group["mu_dtype"] is not None and group["nu_dtype"] is None:
                # optax.adam(mu_dtype) multiplies the stored mu by b1 rounded to
                # mu's dtype (jnp's weak-type rule; exact at the CLI's 0.5)
                b1_mu = float(torch.tensor(b1, dtype=group["mu_dtype"]))
            mu = mu_store.to(f32) * b1_mu + g * (1 - b1)
            nu = nu_store.to(f32) * b2 + (g * g) * (1 - b2)
            for p in params:
                self.state[p]["step"] += 1
            # every parameter of a group steps together, so one count serves all
            count = torch.tensor(float(self.state[params[0]]["step"]), dtype=f32)
            bc1 = float(1 - torch.tensor(b1, dtype=f32) ** count)
            bc2 = float(1 - torch.tensor(b2, dtype=f32) ** count)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + eps) * -lr
            torch._foreach_add_(params, [u.view_as(p).to(p.dtype) for p, u in zip(
                params, upd.split([p.numel() for p in params]))])
            mu_store.copy_(mu)
            nu_store.copy_(nu)
        return loss
