"""Bayesian-optimisation strategy: a Gaussian process and expected
improvement, without scikit-learn.

The port of ``rafiki_tpu/advisor/bayes.py`` (:26-88), which fits
scikit-learn's ``GaussianProcessRegressor``. The card's machine has
numpy and scipy but no scikit-learn, so ``GaussianProcess`` computes
what that regressor computes with the reference's settings:

- the kernel ``ConstantKernel(1.0) * Matern(length_scale=0.5 per
  dimension, nu=2.5)``, with ``alpha`` 1e-4 on the diagonal;
- its hyperparameters fitted in log space by ``scipy.optimize.minimize
  (method="L-BFGS-B")`` on the negative log marginal likelihood and its
  analytic gradient, within the bounds (1e-5, 1e5) of both kernels, from
  the kernel's start and from one restart drawn uniformly within the log
  bounds by ``np.random.RandomState(random_state)``; the lower of the
  two optima wins;
- the posterior mean and standard deviation by Cholesky.

Knobs embed into [0, 1]^d by ``knobs_to_vector``; scores are
standardised before the fit, and EI is maximised over the reference's
candidate set. The advisor's own random stream stays aligned with the
reference's: it draws ``rng.integers(2**31)`` where the reference seeds
the regressor.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
from scipy.linalg import cho_solve, cholesky, solve_triangular
from scipy.optimize import minimize
from scipy.spatial.distance import cdist, pdist, squareform
from scipy.stats import norm

from ..model.knobs import (KnobConfig, Knobs, knobs_to_vector, sample_knobs,
                           searchable_dims, validate_knobs, vector_to_knobs)
from .base import BaseAdvisor, Proposal

_SQRT5 = math.sqrt(5.0)
#: Log bounds of the constant and of each length scale.
_LOG_BOUNDS = (math.log(1e-5), math.log(1e5))


def _matern52(d: np.ndarray) -> np.ndarray:
    """Matern 5/2 of scaled distances ``d``."""
    d = d * _SQRT5
    return (1.0 + d + d ** 2 / 3.0) * np.exp(-d)


class GaussianProcess:
    """``GaussianProcessRegressor(ConstantKernel(1.0) * Matern(
    length_scale=[0.5] * d, nu=2.5), alpha=alpha, n_restarts_optimizer=
    1, random_state=random_state)`` on unnormalised targets."""

    def __init__(self, dims: int, alpha: float = 1e-4,
                 random_state: int = 0):
        self.alpha = alpha
        self.random_state = random_state
        #: log(constant), log(length scale) per dimension.
        self.theta = np.log(np.concatenate([[1.0], np.full(dims, 0.5)]))

    def _kernel(self, theta: np.ndarray, X: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """K(X, X) and its gradient in log space, (n, n, 1 + d)."""
        c, ls = math.exp(theta[0]), np.exp(theta[1:])
        M = squareform(_matern52(pdist(X / ls)))
        np.fill_diagonal(M, 1.0)
        D = (X[:, None, :] - X[None, :, :]) ** 2 / ls ** 2
        tmp = np.sqrt(5.0 * D.sum(-1))[..., None]
        dM = 5.0 / 3.0 * D * (tmp + 1.0) * np.exp(-tmp)
        grad = np.concatenate([(c * M)[..., None], c * dM], axis=-1)
        return c * M, grad

    def neg_log_marginal_likelihood(self, theta: np.ndarray
                                    ) -> Tuple[float, np.ndarray]:
        K, K_grad = self._kernel(theta, self.X)
        K[np.diag_indices_from(K)] += self.alpha
        try:
            L = cholesky(K, lower=True, check_finite=False)
        except np.linalg.LinAlgError:
            return math.inf, np.zeros_like(theta)
        y = self.y[:, None]
        a = cho_solve((L, True), y, check_finite=False)
        lml = float((-0.5 * np.einsum("ik,ik->k", y, a)
                     - np.log(np.diag(L)).sum()
                     - K.shape[0] / 2 * np.log(2 * np.pi)).sum())
        inner = np.einsum("ik,jk->ijk", a, a)
        inner -= cho_solve((L, True), np.eye(K.shape[0]),
                           check_finite=False)[..., None]
        grad = 0.5 * np.einsum("ijl,jik->kl", inner, K_grad).sum(-1)
        return -lml, -grad

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GaussianProcess":
        self.X = np.asarray(X, np.float64)
        self.y = np.asarray(y, np.float64)
        bounds = np.tile(np.asarray(_LOG_BOUNDS), (len(self.theta), 1))
        starts = [self.theta,
                  np.random.RandomState(self.random_state).uniform(
                      bounds[:, 0], bounds[:, 1])]
        optima = []
        for start in starts:
            res = minimize(self.neg_log_marginal_likelihood, start,
                           method="L-BFGS-B", jac=True, bounds=bounds)
            optima.append((res.x, float(res.fun)))
        self.theta = optima[int(np.argmin([f for _, f in optima]))][0]
        K, _ = self._kernel(self.theta, self.X)
        K[np.diag_indices_from(K)] += self.alpha
        self.L = cholesky(K, lower=True, check_finite=False)
        self.a = cho_solve((self.L, True), self.y, check_finite=False)
        return self

    def predict(self, Xs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Posterior mean and standard deviation at ``Xs``."""
        c, ls = math.exp(self.theta[0]), np.exp(self.theta[1:])
        Ks = c * _matern52(cdist(np.asarray(Xs, np.float64) / ls,
                                 self.X / ls))
        mean = Ks @ self.a
        V = solve_triangular(self.L, Ks.T, lower=True, check_finite=False)
        var = c - np.einsum("ij,ji->i", V.T, V)
        var[var < 0] = 0.0
        return mean, np.sqrt(var)


class BayesOptAdvisor(BaseAdvisor):
    """GP + EI over the continuous-box embedding of the knob config."""

    def __init__(self, knob_config: KnobConfig, seed: int = 0,
                 n_initial: int = 5, n_candidates: int = 1024,
                 exploration: float = 0.01,
                 total_trials: Optional[int] = None):
        super().__init__(knob_config, seed, total_trials=total_trials)
        self.dims = searchable_dims(knob_config)
        self.n_initial = max(2, n_initial)
        self.n_candidates = n_candidates
        self.exploration = exploration
        self._X: List[np.ndarray] = []
        self._y: List[float] = []

    def _propose_knobs(self, trial_no: int) -> Knobs:
        if self.dims == 0 or len(self._y) < self.n_initial:
            return sample_knobs(self.knob_config, self.rng)
        x = self._maximize_ei()
        knobs = vector_to_knobs(self.knob_config, x, self.rng)
        return validate_knobs(self.knob_config, knobs)

    def _observe(self, proposal: Proposal, score: float) -> None:
        if self.dims == 0:
            return
        self._X.append(knobs_to_vector(self.knob_config, proposal.knobs))
        self._y.append(score)

    def _maximize_ei(self) -> np.ndarray:
        X = np.stack(self._X)
        y = np.asarray(self._y, dtype=np.float64)
        # Normalise scores so the kernel amplitude prior is reasonable.
        y_mean, y_std = y.mean(), y.std() + 1e-9
        yn = (y - y_mean) / y_std
        gp = GaussianProcess(self.dims, alpha=1e-4,
                             random_state=int(self.rng.integers(2**31)))
        gp.fit(X, yn)

        # Candidate set: uniform + jittered copies of the incumbents.
        cand = self.rng.uniform(0, 1, size=(self.n_candidates, self.dims))
        top = X[np.argsort(yn)[-5:]]
        jitter = top[self.rng.integers(len(top), size=self.n_candidates // 4)]
        jitter = np.clip(jitter + self.rng.normal(0, 0.1, jitter.shape), 0, 1)
        cand = np.concatenate([cand, jitter, X[np.argsort(yn)[-2:]]])

        mu, sigma = gp.predict(cand)
        best = yn.max()
        imp = mu - best - self.exploration
        z = imp / np.maximum(sigma, 1e-9)
        ei = imp * norm.cdf(z) + sigma * norm.pdf(z)
        ei[sigma < 1e-9] = 0.0
        return cand[int(np.argmax(ei))]
