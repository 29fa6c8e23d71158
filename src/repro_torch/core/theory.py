"""Theoretical predictions from the paper, used to validate experiments.

Lemma 1  — sign-bit failure probability under unimodal symmetric noise.
Theorem 1 — mini-batch signSGD convergence bound (mixed norm).
Theorem 2 — majority-vote-with-adversaries convergence bound, and the
            per-coordinate vote failure bound (*) it rests on.

Benchmarks/tests check measured quantities against these bounds.
"""
from __future__ import annotations

import numpy as np

CRITICAL_SNR = 2.0 / np.sqrt(3.0)


def lemma1_failure_prob(snr: np.ndarray) -> np.ndarray:
    """P[sign(g~) != sign(g)] bound as a function of S = |g|/sigma."""
    snr = np.asarray(snr, dtype=np.float64)
    high = 2.0 / (9.0 * np.maximum(snr, 1e-30) ** 2)
    low = 0.5 - snr / (2 * np.sqrt(3.0))
    return np.where(snr > CRITICAL_SNR, high, low)


def gauss_tail_bound(k_over_tau: np.ndarray) -> np.ndarray:
    """Gauss (1823) tail bound for unimodal X: P[|X - mode| > k]."""
    r = np.asarray(k_over_tau, dtype=np.float64)
    return np.where(r > CRITICAL_SNR, 4.0 / (9.0 * np.maximum(r, 1e-30) ** 2),
                    1.0 - r / np.sqrt(3.0))


def theorem1_bound(l_norm1: float, f0_minus_fstar: float, n_calls: int
                   ) -> float:
    """Upper bound on (1/K) sum_k E[mixed-norm of g_k] after N=K calls."""
    return 3.0 * np.sqrt(l_norm1 * f0_minus_fstar / n_calls)


def theorem1_lr(l_norm1: float, f0_minus_fstar: float, k_steps: int) -> float:
    return float(np.sqrt(f0_minus_fstar / (l_norm1 * k_steps)))


def vote_failure_bound(snr: np.ndarray, m_workers: int, alpha: float
                       ) -> np.ndarray:
    """(*) in Thm 2 proof: P[vote fails for coord i] <=
    1 / ((1-2a) sqrt(M) S_i)."""
    snr = np.asarray(snr, dtype=np.float64)
    return 1.0 / ((1 - 2 * alpha) * np.sqrt(m_workers)
                  * np.maximum(snr, 1e-30))


def theorem2_bound(sigma_norm1: float, l_norm1: float,
                   f0_minus_fstar: float, m_workers: int, alpha: float,
                   n_calls_per_worker: int) -> float:
    """Upper bound on [ (1/K) sum_k E||g_k||_1 ]^2 with N = K^2 calls."""
    inner = (sigma_norm1 / ((1 - 2 * alpha) * np.sqrt(m_workers))
             + np.sqrt(l_norm1 * f0_minus_fstar))
    return 4.0 / np.sqrt(n_calls_per_worker) * inner ** 2


def quadratic_problem(dim: int = 1000, noise: float = 1.0, seed: int = 0):
    """The paper's Fig.-1 toy: f(x) = 0.5 ||x||^2 with N(0, noise^2)
    per-coordinate gradient noise. Returns (f, grad_oracle, x0)."""
    rng = np.random.default_rng(seed)
    x0 = rng.normal(size=(dim,)).astype(np.float64)

    def f(x):
        return 0.5 * float(np.dot(x, x))

    def grad_oracle(x, rng_):
        return x + noise * rng_.normal(size=x.shape)

    return f, grad_oracle, x0
