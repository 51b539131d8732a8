"""Action distributions (counterpart of baselines_tpu/nn/distributions.py, after the
reference's common/distributions.py): ``CategoricalPd`` (:153-204), ``MultiCategoricalPd``
(:206-225), ``DiagGaussianPd`` (:227-251), ``BernoulliPd`` (:254-276), and ``PdType``
with ``make_pdtype`` (:278-290).

A ``Pd`` wraps flat parameters, as the JAX package's does. Sampling takes its noise from
the caller: ``pd.noise(draws)`` draws it from a ``Draws`` (core/rng.py) in the JAX
package's order, and ``pd.sample(noise)`` turns it into actions, so a test can feed the
noise the JAX package drew.

- categorical: Gumbel uniforms in [1e-10, 1) of the logits' shape;
- multi-categorical: one such uniform tensor for each categorical, in order;
- diagonal Gaussian: standard normals of the mean's shape;
- Bernoulli: uniforms in [0, 1) of the logits' shape.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from baselines_tpu_torch.envs.spaces import Box, Discrete, MultiBinary, MultiDiscrete

# f32 constants as the JAX package computes them: jnp.log of the f32 value
_HALF_LOG_2PI = float(np.float32(0.5) * np.log(np.float32(2.0 * np.pi)))
_HALF_LOG_2PI_E = float(np.float32(0.5) * np.log(np.float32(2.0 * np.pi * np.e)))


class Pd:
    """The base of the four distributions (distributions.py:23-43); ``logp`` is
    ``-neglogp``."""

    def flatparam(self) -> torch.Tensor:
        raise NotImplementedError

    def mode(self) -> torch.Tensor:
        raise NotImplementedError

    def neglogp(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def kl(self, other: "Pd") -> torch.Tensor:
        raise NotImplementedError

    def entropy(self) -> torch.Tensor:
        raise NotImplementedError

    def noise(self, draws):
        raise NotImplementedError

    def sample(self, noise) -> torch.Tensor:
        raise NotImplementedError

    def logp(self, x: torch.Tensor) -> torch.Tensor:
        return -self.neglogp(x)


class CategoricalPd(Pd):
    def __init__(self, logits: torch.Tensor):
        self.logits = logits

    def flatparam(self) -> torch.Tensor:
        return self.logits

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, dim=-1).to(torch.int32)

    def neglogp(self, x: torch.Tensor) -> torch.Tensor:
        """Sparse softmax cross-entropy (distributions.py:169-183)."""
        logp = F.log_softmax(self.logits, dim=-1)
        return -torch.gather(logp, -1, x.long().unsqueeze(-1)).squeeze(-1)

    def kl(self, other: "CategoricalPd") -> torch.Tensor:
        """Stable KL (distributions.py:184-191)."""
        a0 = self.logits - self.logits.amax(dim=-1, keepdim=True)
        a1 = other.logits - other.logits.amax(dim=-1, keepdim=True)
        ea0, ea1 = torch.exp(a0), torch.exp(a1)
        z0, z1 = ea0.sum(dim=-1, keepdim=True), ea1.sum(dim=-1, keepdim=True)
        p0 = ea0 / z0
        return torch.sum(p0 * (a0 - torch.log(z0) - a1 + torch.log(z1)), dim=-1)

    def entropy(self) -> torch.Tensor:
        """Stable entropy (distributions.py:192-198)."""
        a0 = self.logits - self.logits.amax(dim=-1, keepdim=True)
        ea0 = torch.exp(a0)
        z0 = ea0.sum(dim=-1, keepdim=True)
        p0 = ea0 / z0
        return torch.sum(p0 * (torch.log(z0) - a0), dim=-1)

    def noise(self, draws) -> torch.Tensor:
        return draws.uniform(self.logits.shape, 1e-10, 1.0)

    def sample(self, u: torch.Tensor) -> torch.Tensor:
        """Gumbel-max sampling (distributions.py:199-201) from uniforms ``u`` in
        [1e-10, 1) of the logits' shape."""
        return torch.argmax(self.logits - torch.log(-torch.log(u)), dim=-1).to(torch.int32)


class MultiCategoricalPd(Pd):
    """Independent categoricals over a MultiDiscrete space (distributions.py:86-117)."""

    def __init__(self, nvec, flat: torch.Tensor):
        self.nvec = tuple(int(n) for n in np.asarray(nvec).ravel())
        self.flat = flat
        self.categoricals = [CategoricalPd(x) for x in torch.split(flat, self.nvec, dim=-1)]

    def flatparam(self) -> torch.Tensor:
        return self.flat

    def mode(self) -> torch.Tensor:
        return torch.stack([p.mode() for p in self.categoricals], dim=-1)

    def neglogp(self, x: torch.Tensor) -> torch.Tensor:
        return sum(p.neglogp(x[..., i]) for i, p in enumerate(self.categoricals))

    def kl(self, other: "MultiCategoricalPd") -> torch.Tensor:
        return sum(p.kl(q) for p, q in zip(self.categoricals, other.categoricals))

    def entropy(self) -> torch.Tensor:
        return sum(p.entropy() for p in self.categoricals)

    def noise(self, draws) -> list:
        return [p.noise(draws) for p in self.categoricals]

    def sample(self, us) -> torch.Tensor:
        return torch.stack([p.sample(u) for p, u in zip(self.categoricals, us)], dim=-1)


class DiagGaussianPd(Pd):
    """flat = concat(mean, logstd) on the last axis (distributions.py:120-159)."""

    def __init__(self, flat: torch.Tensor):
        self.flat = flat
        self.mean, self.logstd = torch.chunk(flat, 2, dim=-1)
        self.std = torch.exp(self.logstd)

    def flatparam(self) -> torch.Tensor:
        return self.flat

    def mode(self) -> torch.Tensor:
        return self.mean

    def neglogp(self, x: torch.Tensor) -> torch.Tensor:
        d = self.mean.shape[-1]
        return (0.5 * torch.sum(torch.square((x - self.mean) / self.std), dim=-1)
                + _HALF_LOG_2PI * d + torch.sum(self.logstd, dim=-1))

    def kl(self, other: "DiagGaussianPd") -> torch.Tensor:
        return torch.sum(
            other.logstd - self.logstd
            + (torch.square(self.std) + torch.square(self.mean - other.mean))
            / (2.0 * torch.square(other.std))
            - 0.5,
            dim=-1,
        )

    def entropy(self) -> torch.Tensor:
        return torch.sum(self.logstd + _HALF_LOG_2PI_E, dim=-1)

    def noise(self, draws) -> torch.Tensor:
        return draws.normal(self.mean.shape)

    def sample(self, z: torch.Tensor) -> torch.Tensor:
        """mean + std * z for standard normals ``z`` of the mean's shape."""
        return self.mean + self.std * z


class BernoulliPd(Pd):
    """Independent Bernoullis from logits (distributions.py:162-196)."""

    def __init__(self, logits: torch.Tensor):
        self.logits = logits
        self.ps = torch.sigmoid(logits)

    def flatparam(self) -> torch.Tensor:
        return self.logits

    def mode(self) -> torch.Tensor:
        return torch.round(self.ps).to(torch.int32)

    @staticmethod
    def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Sigmoid cross-entropy with logits: max(x, 0) - x z + log(1 + exp(-|x|))."""
        return (torch.clamp(logits, min=0.0) - logits * labels
                + torch.log1p(torch.exp(-torch.abs(logits))))

    def neglogp(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(self._bce(self.logits, x.to(self.ps.dtype)), dim=-1)

    def kl(self, other: "BernoulliPd") -> torch.Tensor:
        return torch.sum(self._bce(other.logits, self.ps) - self._bce(self.logits, self.ps),
                         dim=-1)

    def entropy(self) -> torch.Tensor:
        return torch.sum(self._bce(self.logits, self.ps), dim=-1)

    def noise(self, draws) -> torch.Tensor:
        return draws.uniform(self.ps.shape, 0.0, 1.0)

    def sample(self, u: torch.Tensor) -> torch.Tensor:
        return (u < self.ps).to(torch.int32)


class PdType:
    """The flat-parameter width and the sample's shape and dtype of an action space
    (distributions.py:199-239)."""

    def __init__(self, space):
        self.space = space
        if isinstance(space, Discrete):
            self.kind, self.param_size = "categorical", space.n
            self.sample_shape, self.sample_dtype = (), torch.int32
        elif isinstance(space, MultiDiscrete):
            self.nvec = np.asarray(space.nvec).ravel()
            self.kind, self.param_size = "multicategorical", int(self.nvec.sum())
            self.sample_shape, self.sample_dtype = (len(self.nvec),), torch.int32
        elif isinstance(space, Box):
            if len(space.shape) != 1:
                raise ValueError(f"Box actions must be flat vectors, got {space.shape}")
            self.kind, self.param_size = "diag_gaussian", 2 * space.shape[0]
            self.sample_shape, self.sample_dtype = tuple(space.shape), torch.float32
        elif isinstance(space, MultiBinary):
            self.kind, self.param_size = "bernoulli", space.n
            self.sample_shape, self.sample_dtype = (space.n,), torch.int32
        else:
            raise NotImplementedError(f"no distribution for space {space!r}")

    def pdfromflat(self, flat: torch.Tensor) -> Pd:
        if self.kind == "categorical":
            return CategoricalPd(flat)
        if self.kind == "multicategorical":
            return MultiCategoricalPd(self.nvec, flat)
        if self.kind == "diag_gaussian":
            return DiagGaussianPd(flat)
        return BernoulliPd(flat)


def make_pdtype(space) -> PdType:
    """Space -> PdType (distributions.py:242-244)."""
    return PdType(space)
