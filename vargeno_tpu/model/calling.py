"""Genotype-likelihood model and GQ computation.

Vectorized reimplementation of choose_best_genotype (src/qv.cc:1789-1848):

  g0 = (1-e)^r * e^a,  g1 = 0.5^(r+a),  g2 = e^r * (1-e)^a   (e = ERR_RATE)
  priors p^2, (1 - p^2 - q^2), q^2 from freqs decoded as enc/255
  genotype = argmax of prior*likelihood with the reference's strict-greater
  tie-breaking (ties fall through to ALT, src/qv.cc:1841-1846)
  confidence = posterior * Poisson(n; AVG_COV),  n = r + a
  GQ = (int)(-10 * ln(confidence))  [natural log, C int truncation]

(0,0) and (MAX_COV,MAX_COV) count pairs yield no call (src/qv.cc:1821-1823).

Host path uses float64 numpy to match the reference's double math digit for
digit; a bfloat16/f32 device variant lives in the engine for on-device
calling when bit-parity is not required.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import GTYPE_ALT, GTYPE_HET, GTYPE_NONE, GTYPE_REF, GenoConfig


@dataclasses.dataclass
class Calls:
    genotype: np.ndarray    # (s,) uint8 GTYPE_*
    confidence: np.ndarray  # (s,) float64
    gq: np.ndarray          # (s,) int32, valid where genotype != NONE


def call_genotypes(ref_cnt: np.ndarray, alt_cnt: np.ndarray,
                   rf_enc: np.ndarray, af_enc: np.ndarray,
                   config: GenoConfig) -> Calls:
    r = np.asarray(ref_cnt, np.int64)
    a = np.asarray(alt_cnt, np.int64)
    e = config.err_rate
    max_cov = config.max_cov

    g0 = np.power(1.0 - e, r) * np.power(e, a)
    g1 = np.power(0.5, r + a)
    g2 = np.power(e, r) * np.power(1.0 - e, a)

    p = np.asarray(rf_enc, np.float64) / 255.0
    q = np.asarray(af_enc, np.float64) / 255.0
    p2 = p * p
    q2 = q * q

    pg0 = p2 * g0
    pg1 = (1.0 - p2 - q2) * g1
    pg2 = q2 * g2
    total = pg0 + pg1 + pg2

    n = r + a
    lam = config.avg_cov
    # poisson pmf exactly as the reference computes it:
    # exp(-lam) * lam^n / exp(lgamma(n+1))  (src/qv.cc:1813-1815)
    import math

    poisson = np.array([
        math.exp(-lam) * (lam ** i) / math.exp(math.lgamma(i + 1.0))
        for i in range(2 * max_cov + 1)
    ])
    pois = poisson[np.clip(n, 0, 2 * max_cov)]

    with np.errstate(divide="ignore", invalid="ignore"):
        gt = np.where(
            (pg0 > pg1) & (pg0 > pg2), GTYPE_REF,
            np.where((pg1 > pg0) & (pg1 > pg2), GTYPE_HET, GTYPE_ALT),
        ).astype(np.uint8)
        conf = np.where(
            gt == GTYPE_REF, pg0 / total,
            np.where(gt == GTYPE_HET, pg1 / total, pg2 / total)) * pois

    none_mask = ((r == 0) & (a == 0)) | ((r == max_cov) & (a == max_cov))
    gt = np.where(none_mask, GTYPE_NONE, gt).astype(np.uint8)
    conf = np.where(none_mask, 0.0, conf)

    with np.errstate(divide="ignore"):
        gq = np.where(conf > 0, (-10.0 * np.log(conf)), 0.0)
    gq = gq.astype(np.int32)  # C (int) cast truncates toward zero
    return Calls(genotype=gt, confidence=conf, gq=gq)
