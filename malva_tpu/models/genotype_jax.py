"""Vmapped device genotype-likelihood model.

Bulk GT/GQ computation for padded variant batches on device (float32).  The
math mirrors models.genotype (reference: var_block.hpp:224-330) — binomial
likelihood via Stirling log-binomial with allele-frequency priors — but in
f32 without the host path's exact float-promotion quirks; the scalar host
model remains the authority for emitted VCFs, and tests check that this
model agrees with it on the argmax genotype for non-degenerate posteriors.

Layout: variants padded to A alleles.
  coverages: (B, A) int32   per-allele coverage (0 padding)
  freqs:     (B, A) float32 allele frequencies (0 padding)
  n_alleles: (B,)   int32   true allele count per variant (>= 1)
Static: A (max alleles), haploid, error_rate, max_cov.

Returns (best_g1, best_g2, gq): int32/int32/int32 arrays of shape (B,).
For haploid calls best_g2 == best_g1.
"""

from __future__ import annotations

import numpy as np


def make_genotype_fn(max_alleles: int, haploid: bool, error_rate: float, max_cov: int):
    import jax
    import jax.numpy as jnp

    A = max_alleles
    er = np.float32(error_rate)

    if haploid:
        pairs = [(g, g) for g in range(A)]
    else:
        pairs = [(g1, g2) for g1 in range(A) for g2 in range(g1, A)]
    g1s = np.array([p[0] for p in pairs], dtype=np.int32)
    g2s = np.array([p[1] for p in pairs], dtype=np.int32)

    def log_binom(n, k):
        # Stirling form with the 0-edge guard (var_block.hpp:792-797)
        n_f = n.astype(jnp.float32)
        k_f = k.astype(jnp.float32)
        d_f = (n - k).astype(jnp.float32)
        safe = lambda x: jnp.where(x > 0, jnp.log(jnp.maximum(x, 1.0)) * x, 0.0)
        out = safe(n_f) - safe(k_f) - safe(d_f)
        return jnp.where((n == 0) | (n == k) | (k == 0), 0.0, out)

    @jax.jit
    def genotype(coverages, freqs, n_alleles):
        cov = coverages.astype(jnp.int32)
        total = jnp.sum(cov, axis=1)
        n_all = n_alleles.astype(jnp.int32)

        logp = []
        for g1, g2 in pairs:
            c1 = cov[:, g1]
            f1 = freqs[:, g1]
            if g1 == g2:
                prior = 2.0 * jnp.log(jnp.maximum(f1, 1e-38)) + jnp.where(f1 > 0, 0.0, -jnp.inf)
                err = total - c1
                denom = jnp.maximum(n_all - 1, 1).astype(jnp.float32)
                post = (
                    log_binom(c1 + err, c1)
                    + c1.astype(jnp.float32) * np.float32(np.log(1.0 - er))
                    + err.astype(jnp.float32) * jnp.log(er / denom)
                )
            else:
                c2 = cov[:, g2]
                f2 = freqs[:, g2]
                pf = 2.0 * f1 * f2
                prior = jnp.log(jnp.maximum(pf, 1e-38)) + jnp.where(pf > 0, 0.0, -jnp.inf)
                err = total - c1 - c2
                denom = jnp.maximum(n_all - 2, 1).astype(jnp.float32)
                post = (
                    log_binom(c1 + c2 + err, c1 + c2)
                    + log_binom(c1 + c2, c1)
                    + (c1 + c2).astype(jnp.float32) * np.float32(np.log((1.0 - er) / 2.0))
                    + jnp.where(n_all > 2, err.astype(jnp.float32) * jnp.log(er / denom), 0.0)
                )
            valid = (g2 < n_all) if not haploid else (g1 < n_all)
            logp.append(jnp.where(valid, prior + post, -jnp.inf))
        logp = jnp.stack(logp, axis=1)  # (B, n_pairs)

        # normalize in log space: raw probabilities underflow f32 fast
        m = jnp.max(logp, axis=1, keepdims=True)
        finite = jnp.isfinite(m[:, 0])
        rel = jnp.exp(logp - jnp.where(jnp.isfinite(m), m, 0.0))
        total_q = jnp.sum(rel, axis=1, keepdims=True)
        qual = rel / jnp.maximum(total_q, 1e-30)
        best = jnp.argmax(logp, axis=1)
        best_q = jnp.take_along_axis(qual, best[:, None], axis=1)[:, 0]

        # degenerate cases: no coverage / single allele / over-covered
        over = jnp.any(cov > max_cov, axis=1)
        degenerate = over | (total == 0) | (n_all == 1) | ~finite
        best = jnp.where(degenerate, 0, best)
        gq = jnp.where(degenerate, 0, jnp.round(best_q * 100).astype(jnp.int32))

        bg1 = jnp.take(jnp.asarray(g1s), best)
        bg2 = jnp.take(jnp.asarray(g2s), best)
        return bg1, bg2, gq

    return genotype
