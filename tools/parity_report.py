"""Combine engine_run/oracle_run JSONLs into the layer-3 parity verdict.

Reads the per-seed quality records produced by tools/engine_run.py (engine
side) and tools/oracle_run.py (NumPy side) — both judged by the same f64
oracle judge — and reports the relative gap of the mean ΔE and MSE with
its 1σ seed-noise, so the PASS statement is explicit about what the seed
budget can and cannot resolve (docs/PARITY.md layer 3).

Usage:
  python tools/parity_report.py --engine engine.jsonl --oracle oracle.jsonl
      [--tolerance 0.01]
"""

from __future__ import annotations

import argparse
import json
import math


def load(path):
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                recs.append(json.loads(line))
    return recs


def stats(vals):
    n = len(vals)
    mean = sum(vals) / n
    var = sum((v - mean) ** 2 for v in vals) / (n - 1) if n > 1 else 0.0
    return mean, math.sqrt(var), math.sqrt(var / n) if n > 1 else float("inf")


def median(vals):
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def trimmed_mean(vals, frac=0.2):
    """Mean after dropping frac/2 of the sample at each end (>=1 point
    per end once n >= 5), the standard guard against basin-tail seeds."""
    s = sorted(vals)
    k = max(1, int(len(s) * frac / 2)) if len(s) >= 5 else 0
    core = s[k : len(s) - k] if k else s
    return sum(core) / len(core)


def rank_sum_p(a, b):
    """Two-sided Mann-Whitney p (normal approx with tie correction):
    probability of a rank split this extreme if engine and oracle seeds
    were drawn from ONE distribution. Distribution-shape evidence the
    mean gate cannot see (round-4 VERDICT Weak #2)."""
    allv = sorted((v, 0) for v in a) + sorted((v, 1) for v in b)
    allv.sort()
    ranks, i = {}, 0
    vals = [v for v, _ in allv]
    while i < len(vals):
        j = i
        while j < len(vals) and vals[j] == vals[i]:
            j += 1
        for k in range(i, j):
            ranks[k] = (i + j + 1) / 2  # 1-based average rank
        i = j
    ra = sum(ranks[k] for k, (_, side) in enumerate(allv) if side == 0)
    n1, n2 = len(a), len(b)
    u = ra - n1 * (n1 + 1) / 2
    mu = n1 * n2 / 2
    # tie-corrected variance
    n = n1 + n2
    ties = {}
    for v in vals:
        ties[v] = ties.get(v, 0) + 1
    tie_term = sum(t**3 - t for t in ties.values())
    var = n1 * n2 / 12 * ((n + 1) - tie_term / (n * (n - 1)))
    if var <= 0:
        return 1.0
    z = max(0.0, abs(u - mu) - 0.5) / math.sqrt(var)
    # two-sided normal tail via erfc
    return math.erfc(z / math.sqrt(2))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", required=True)
    ap.add_argument("--oracle", required=True)
    ap.add_argument("--tolerance", type=float, default=0.01)
    args = ap.parse_args()

    eng, ora = load(args.engine), load(args.oracle)
    if not eng or not ora:
        print("need at least one record on each side")
        return 2
    cfg_keys = ("size", "colors", "imax", "population")
    # "content" is absent from pre-round-4 records (all smooth content)
    cfgs = {
        tuple(r[k] for k in cfg_keys) + (r.get("content", "smooth"),)
        for r in eng + ora
    }
    if len(cfgs) != 1:
        print(f"WARNING: mixed configs in inputs: {cfgs}")

    verdicts = []
    for metric in ("deltaE", "mse"):
        em, es, esem = stats([r[metric] for r in eng])
        om, osd, osem = stats([r[metric] for r in ora])
        gap = (em - om) / om
        noise = math.sqrt(esem**2 + osem**2) / om  # 1σ of the gap estimate
        print(
            f"{metric}: engine {em:.5g} ± {esem:.2g} (n={len(eng)}, "
            f"std {es:.3g})  oracle {om:.5g} ± {osem:.2g} (n={len(ora)}, "
            f"std {osd:.3g})"
        )
        print(f"  gap {gap * 100:+.2f}%  ± {noise * 100:.2f}% (1σ seed noise)")
        verdicts.append((metric, gap, noise))

    # Distribution-aware addendum (round-4 VERDICT Weak #2): the mean gate
    # above stays the verdict; this block answers whether a gap (or a PASS)
    # is driven by basin-tail seeds rather than a shifted distribution.
    ev = [r["deltaE"] for r in eng]
    ov = [r["deltaE"] for r in ora]
    print("deltaE distribution: "
          f"median gap {(median(ev) - median(ov)) / median(ov) * 100:+.2f}%  "
          f"20%-trimmed-mean gap "
          f"{(trimmed_mean(ev) - trimmed_mean(ov)) / trimmed_mean(ov) * 100:+.2f}%")
    above = sum(v > max(ev) for v in ov)
    below = sum(v < min(ev) for v in ov)
    print(f"  tails: {above}/{len(ov)} oracle seeds above the engine max "
          f"({max(ev):.4g}), {below}/{len(ov)} below the engine min "
          f"({min(ev):.4g}); engine range [{min(ev):.4g}, {max(ev):.4g}], "
          f"oracle range [{min(ov):.4g}, {max(ov):.4g}]")
    if len(ev) > 1 and len(ov) > 1:
        # Dispersion (descriptive, no p-value: anneal-final quality is
        # right-skewed, so an F-test's normality premise fails): a spread
        # ratio well above 1 with matching means/medians says the sides
        # agree in location but one walks into bad basins more often.
        es = stats(ev)[1]
        osd = stats(ov)[1]
        eq = sorted(ev)
        oq = sorted(ov)
        iqr = lambda s: s[(3 * len(s)) // 4] - s[len(s) // 4]  # noqa: E731
        print(f"  dispersion: per-seed std engine {es:.3g} vs oracle "
              f"{osd:.3g} (ratio {osd / es:.2f}), IQR {iqr(eq):.3g} vs "
              f"{iqr(oq):.3g}"
              + (f" (ratio {iqr(oq) / iqr(eq):.2f})" if iqr(eq) > 0 else ""))
        p = rank_sum_p(ev, ov)
        print(f"  rank-sum (Mann-Whitney, two-sided, tie-corrected): "
              f"p = {p:.3f} for 'same distribution'"
              + ("  — shapes indistinguishable at this n" if p > 0.05
                 else "  — distributions DIFFER; mean-gap verdict may be"
                      " tail-driven, read the tail counts above"))

    de_gap, de_noise = verdicts[0][1], verdicts[0][2]
    if abs(de_gap) + de_noise <= args.tolerance:
        # Power-gated PASS: the 1σ upper bound on the TRUE gap
        # (|measured gap| + seed noise) must fit inside the tolerance —
        # otherwise an n=2 run with ~4% noise could report a lucky small
        # gap and claim a parity the seed budget cannot resolve.
        print(f"PARITY: PASS (|ΔE gap| {abs(de_gap)*100:.2f}% + 1σ noise "
              f"{de_noise*100:.2f}% <= {args.tolerance:.0%})")
        return 0
    if abs(de_gap) <= args.tolerance:
        print(
            f"PARITY: INCONCLUSIVE — |gap| {abs(de_gap)*100:.2f}% is within "
            f"{args.tolerance:.0%} but the 1σ seed noise "
            f"({de_noise*100:.2f}%) pushes its upper bound past the "
            "tolerance, so this seed budget cannot resolve a pass; add "
            "seeds (both runners resume from their JSONL)"
        )
        return 1
    if abs(de_gap) - 2 * de_noise <= args.tolerance:
        print(
            f"PARITY: INCONCLUSIVE — |gap| {abs(de_gap)*100:.2f}% exceeds "
            f"{args.tolerance:.0%} but is within 2σ ({2*de_noise*100:.2f}%) "
            "of it; add seeds (both runners resume from their JSONL)"
        )
        return 1
    print(f"PARITY: FAIL (|gap| {abs(de_gap)*100:.2f}% > {args.tolerance:.0%} "
          f"beyond 2σ noise {2*de_noise*100:.2f}%)")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
