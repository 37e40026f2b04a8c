"""Cross-safe_mult validation gate (counterpart of
montecarlo_tpu/validation.py).

The float32 propagation modes trade per-window drift (reset at every UDT
stabilization) for throughput. Whether that drift biases the Markov chain
cannot be read off the drift monitor alone; the criterion is that runs at
the candidate safe_mult reproduce the correlators of drift-proof
safe_mult = 1 runs within statistical errors, over independent seeds. The
observable set includes the τ-integrated susceptibilities (CDS, PS), which
drag Green's factors through the longest unstabilized windows of the
combined iterator.

``cross_sm_check`` runs the candidate mode and the anchor (the same model
and dtype at anchor_sm, by default 1) over the same seeds, each as one
batched session (``DQMC(seed=seeds)``), and compares the pooled per-chain
means with Bonferroni-scaled z-tests (``compare_pools``). Anchors persist
on disk under a key built once, from ``PROTOCOL`` (``anchor_config``), with
the kernel route and the device; each records when and from which code it
was derived (``derived_at``).

    python3 -m montecarlo_tpu_torch.validation headline [--refuse-cache]
    python3 -m montecarlo_tpu_torch.validation refresh [--refuse-cache]

run a gate of ``GATES`` on the card and print its result as one JSON line:
the headline gate (``PROTOCOL``: 8x8, beta = 10, U = 4, float32, 64 chains
x seeds (123, 321), 300 + 100 sweeps, safe_mult 10 against 1, kernels on
both sides) or the conservative gate (bench.py's refresh_gate: the same
protocol with the candidate at safe_mult ``REFRESH_SM`` under g_refresh,
against the headline's anchor, the same cache key).
"""

from __future__ import annotations

import datetime
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

DEFAULT_OBSERVABLES = ("occ", "greens", "CDC", "PC", "SDCz", "CDS", "PS")
# the equal-time subset, for operating points where the combined iterator
# is too expensive for a gate (L = 16)
EQUAL_TIME_OBSERVABLES = ("occ", "greens", "CDC", "PC", "SDCz")

# The protocol of a pooled run: every field that decides an anchor, with
# the defaults of the JAX package's cross_sm_check (bench.py's headline
# gate). Every entry point of this module and the anchor cache key read
# this one table.
PROTOCOL = dict(L=8, beta=10.0, U=4.0, mu=0.0, dtype="float32", n_chains=64,
                sweeps=300, thermalization=100, measure_rate=5,
                seeds=(123, 321), peierls=None,
                observables=DEFAULT_OBSERVABLES)
# the fields a candidate run may change without touching the anchor
CANDIDATE_FIELDS = ("sweeps", "thermalization", "seeds", "n_chains")
ANCHOR_VERSION = 1
# the conservative mode's safe_mult (bench.py's REFRESH_SM)
REFRESH_SM = 5
# the gates of the command line: each one's cross_sm_check keywords beside
# the protocol (its candidate mode); all share the safe_mult=1 anchor
GATES = {"headline": {},
         "refresh": dict(safe_mult=REFRESH_SM, g_refresh=True)}
ROOT = Path(__file__).resolve().parent.parent


def protocol(**overrides) -> Dict:
    """PROTOCOL with overrides; an unknown field raises TypeError."""
    unknown = set(overrides) - set(PROTOCOL)
    if unknown:
        raise TypeError(f"unknown protocol fields {sorted(unknown)} (the "
                        f"protocol has {sorted(PROTOCOL)})")
    return {**PROTOCOL, **overrides}


def _device_type(device):
    return str(device).split(":")[0]


def anchor_config(anchor_sm: int = 1, use_kernels: bool = True,
                  anchor_use_kernels: Optional[bool] = None,
                  device="cuda", **overrides) -> Dict:
    """The anchor's full configuration, and its cache key: the protocol,
    the anchor's safe_mult, its kernel route and device type, and the
    record version."""
    route = use_kernels if anchor_use_kernels is None else anchor_use_kernels
    return dict(protocol(**overrides), safe_mult=int(anchor_sm),
                use_kernels=bool(route), device=_device_type(device),
                version=ANCHOR_VERSION)


def _run_one(model_kwargs, dqmc_kwargs, observables=DEFAULT_OBSERVABLES):
    """One run; returns {obs_key: per-chain-mean array (C, ...)} plus
    acceptance and drift diagnostics under '_'-prefixed keys."""
    from . import DQMC, HubbardModelAttractive
    from .measurements import dqmc_measurements as dm

    model = HubbardModelAttractive(**model_kwargs)
    mc = DQMC(model, **dqmc_kwargs)
    adders = {
        "CDC": lambda: dm.charge_density_correlation(mc, model),
        "PC": lambda: dm.pairing_correlation(mc, model, K=4),
        "SDCz": lambda: dm.spin_density_correlation(mc, model, "z"),
        # τ-integrated susceptibilities: the longest-window stress test
        "CDS": lambda: dm.charge_density_susceptibility(mc, model),
        "PS": lambda: dm.pairing_susceptibility(mc, model, K=4),
    }
    for key, make in adders.items():
        if key in observables:
            mc[key] = make()
    mc.run(verbose=False, chunk=50)
    out = {}
    for key, results in mc.observables().items():
        for name, res in results.items():
            if hasattr(res, "per_chain_mean"):
                out[f"{key}/{name}"] = np.asarray(res.per_chain_mean)
    out["_acc"] = mc.analysis.acc_rate
    out["_perr_mean"] = mc.analysis.prop_err_mean
    out["_perr_hist"] = list(mc.analysis.prop_err_hist)
    return out


def pooled_run(safe_mult: int = 1, use_kernels: bool = True, device="cuda",
               g_refresh: bool = False, **overrides) -> Dict:
    """Run one (dtype, safe_mult, kernels) mode over the protocol's seeds
    as one batched session and pool the per-chain means across seeds
    (every chain is an independent Markov chain, so the cross-chain scatter
    of len(seeds)·n_chains means is an autocorrelation-free standard
    error). Returns {obs_key: (len(seeds)·n_chains, ...) array} plus
    '_'-prefixed diagnostics as single-element lists (the JAX package's
    record format)."""
    import torch

    p = protocol(**overrides)
    mk = dict(dims=2, L=p["L"], U=p["U"], mu=p["mu"])
    if p["peierls"] is not None:
        mk["peierls"] = p["peierls"]
    dk = dict(beta=p["beta"], n_chains=p["n_chains"], sweeps=p["sweeps"],
              thermalization=p["thermalization"],
              measure_rate=p["measure_rate"], print_rate=10 ** 9,
              dtype=getattr(torch, p["dtype"]), use_kernels=use_kernels,
              device=device, safe_mult=safe_mult, g_refresh=g_refresh,
              seed=tuple(p["seeds"]))
    run = _run_one(mk, dk, observables=p["observables"])
    return {key: ([val] if key.startswith("_") else val)
            for key, val in run.items()}


def _cache_dir() -> str:
    """MC_TORCH_ANCHOR_CACHE, default <repo>/.torch_anchor_cache (git
    ignored); "" disables the cache."""
    return os.environ.get("MC_TORCH_ANCHOR_CACHE",
                          str(ROOT / ".torch_anchor_cache"))


def _anchor_cache_path(cfg: Dict) -> str:
    """Deterministic on-disk location of a pooled anchor run, from its
    configuration (``anchor_config``); "" where the cache is disabled."""
    base = _cache_dir()
    if not base:
        return ""
    key = json.dumps(
        {k: (v.tolist() if isinstance(v, np.ndarray) else
             list(v) if isinstance(v, tuple) else v)
         for k, v in sorted(cfg.items())}, sort_keys=True)
    h = hashlib.sha256(key.encode()).hexdigest()[:16]
    return os.path.join(base, f"anchor_{h}.npz")


def anchor_cache_exists(**gate_kwargs) -> bool:
    """True when the pooled anchor of a ``cross_sm_check`` with these
    keywords is on disk. Takes the gate's exact keywords; the
    candidate-only ones do not enter the key."""
    kw = {k: v for k, v in gate_kwargs.items()
          if k in PROTOCOL or k in ("anchor_sm", "use_kernels",
                                    "anchor_use_kernels", "device")}
    path = _anchor_cache_path(anchor_config(**kw))
    return bool(path) and os.path.exists(path)


def source_digest() -> str:
    """sha256 (16 hex digits) of the package's sources (Python and CUDA),
    which names the code that derived a record where git does not."""
    h = hashlib.sha256()
    pkg = Path(__file__).resolve().parent
    for f in sorted(list(pkg.rglob("*.py")) + list(pkg.rglob("*.cu"))
                    + list(pkg.rglob("*.cuh"))):
        if "_build" in f.parts:
            continue
        h.update(str(f.relative_to(pkg)).encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _commit() -> Optional[str]:
    try:
        out = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def derived_at() -> Dict:
    """When and from which code a record is derived: UTC time, git commit
    (None outside a git checkout) and ``source_digest``."""
    return {"utc": datetime.datetime.now(datetime.timezone.utc).isoformat(
        timespec="seconds"), "commit": _commit(), "source": source_digest()}


def load_or_run_anchor(cfg: Dict, refuse_cache: bool = False) -> Dict:
    """The pooled anchor run of ``anchor_config`` cfg: read from the cache
    unless refuse_cache, else derived live (``pooled_run``) and stored."""
    path = _anchor_cache_path(cfg)
    if path and os.path.exists(path) and not refuse_cache:
        with np.load(path, allow_pickle=True) as z:
            out = {k: (z[k].tolist() if k.startswith("_") else z[k])
                   for k in z.files}
        out["_derived_at"] = json.loads(out["_derived_at"])
        out["_cached"] = True
        return out
    kw = {k: cfg[k] for k in PROTOCOL}
    out = pooled_run(safe_mult=cfg["safe_mult"], use_kernels=cfg["use_kernels"],
                     device=cfg["device"], **kw)
    out["_derived_at"] = derived_at()
    if path:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        rec = {k: (np.asarray(json.dumps(v)) if k == "_derived_at" else
                   np.asarray(v, dtype=object) if k.startswith("_") else v)
               for k, v in out.items()}
        np.savez(path, **rec)
    return out


def compare_pools(cand: Dict, anch: Dict, alpha: float = 0.01):
    """Per-observable max-|z| between two pooled runs with Bonferroni-scaled
    thresholds; returns (ok, z_by_obs, tol_by_obs). The cutoff of an
    observable with n components is the two-sided Bonferroni quantile
    sqrt(2 ln(2 n / alpha)) (~3.3 for a scalar, ~5.3 at n = 4096).
    Components on which every chain agrees to ~5 digits (deterministic up
    to rounding, such as the sign of a pure-gauge session) get an absolute
    gate instead, |m1 - m2| < 1e-3 · scale, reported scaled like z."""
    zs, tols = {}, {}
    ok = True
    for key in cand:
        if key.startswith("_") or key not in anch:
            continue
        pc1, pc2 = cand[key], anch[key]
        m1, e1 = pc1.mean(axis=0), (pc1.std(axis=0, ddof=1)
                                    / np.sqrt(pc1.shape[0]))
        m2, e2 = pc2.mean(axis=0), (pc2.std(axis=0, ddof=1)
                                    / np.sqrt(pc2.shape[0]))
        err = np.sqrt(np.abs(e1) ** 2 + np.abs(e2) ** 2)
        err = np.maximum(err, 1e-12)
        n_comp = int(np.size(m1))
        scale = np.maximum(np.maximum(np.abs(m1), np.abs(m2)), 1e-30)
        degen = err < 1e-5 * scale
        zdeg = np.abs(m1 - m2) / (1e-3 * scale)   # <1 == pass, scaled like z
        zstat = np.abs(m1 - m2) / err
        tol = float(np.sqrt(2.0 * np.log(2.0 * n_comp / alpha)))
        zs[key] = float(np.max(np.where(degen, zdeg * tol, zstat)))
        tols[key] = tol
        ok = ok and zs[key] < tols[key]
    return bool(ok), zs, tols


def cross_sm_check(safe_mult: int = 10, anchor_sm: int = 1,
                   alpha: float = 0.01, use_kernels: bool = True,
                   anchor_use_kernels: Optional[bool] = None, device="cuda",
                   g_refresh: bool = False,
                   anchor_pool: Optional[Dict] = None,
                   refuse_cache: bool = False,
                   cand_sweeps: Optional[int] = None,
                   cand_thermalization: Optional[int] = None,
                   cand_seeds: Optional[Sequence[int]] = None,
                   cand_n_chains: Optional[int] = None,
                   **overrides) -> Dict:
    """Matched-seed comparison of the candidate (dtype, safe_mult, kernels)
    mode against the drift-proof anchor (same protocol at anchor_sm).

    anchor_pool: a precomputed ``pooled_run`` of the anchor, for gates that
    share it. anchor_use_kernels: the anchor's route where it differs from
    the candidate's. refuse_cache: derive the anchor live even where the
    cache holds it. cand_*: candidate-only overrides of the protocol (a
    smaller candidate pool only widens the error bars).

    Returns {"ok", "z", "z_tol", per-side diagnostics, "anchor_cached",
    "derived_at" (the anchor's), "_anchor_pool": the anchor pool for reuse
    (strip '_'-keys before serializing)}."""
    cfg = anchor_config(anchor_sm, use_kernels, anchor_use_kernels, device,
                        **overrides)
    proto = {k: cfg[k] for k in PROTOCOL}
    cand_proto = dict(proto)
    for k, v in zip(CANDIDATE_FIELDS, (cand_sweeps, cand_thermalization,
                                       cand_seeds, cand_n_chains)):
        if v is not None:
            cand_proto[k] = v
    cand = pooled_run(safe_mult=safe_mult, use_kernels=use_kernels,
                      device=device, g_refresh=g_refresh, **cand_proto)
    anch = anchor_pool
    if anch is None:
        anch = load_or_run_anchor(cfg, refuse_cache=refuse_cache)
    ok, zs, tols = compare_pools(cand, anch, alpha=alpha)
    return {
        "ok": ok,
        "seeds": list(proto["seeds"]),
        "anchor_cached": bool(anch.get("_cached", False)),
        "derived_at": anch.get("_derived_at"),
        "z": zs,
        "z_tol": tols,
        "candidate": {"safe_mult": safe_mult, "g_refresh": bool(g_refresh),
                      "use_kernels": bool(use_kernels),
                      "sweeps": cand_proto["sweeps"],
                      "seeds": list(cand_proto["seeds"]),
                      "n_chains": cand_proto["n_chains"],
                      "acc": cand["_acc"],
                      "perr_mean": cand["_perr_mean"],
                      "perr_hist": cand["_perr_hist"]},
        "anchor": {"safe_mult": anchor_sm, "use_kernels": cfg["use_kernels"],
                   "acc": anch["_acc"], "perr_mean": anch["_perr_mean"],
                   "perr_hist": anch["_perr_hist"]},
        "_anchor_pool": anch,
    }


def _gate(name, argv):
    """The gate GATES[name] on the card, its result as one JSON line."""
    import argparse

    import torch

    ap = argparse.ArgumentParser(prog="python3 -m montecarlo_tpu_torch."
                                 f"validation {name}")
    ap.add_argument("--refuse-cache", action="store_true",
                    help="derive the anchor live even if it is cached")
    ap.add_argument("--out", help="also write the JSON to this file")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = cross_sm_check(refuse_cache=args.refuse_cache, **GATES[name])
    res = {k: v for k, v in res.items() if not k.startswith("_")}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    res.update(gate=name, wall_s=time.perf_counter() - t0,
               device=torch.cuda.get_device_name(0), nvidia_smi=smi,
               source_digest=source_digest(),
               protocol={k: (list(v) if isinstance(v, tuple) else v)
                         for k, v in PROTOCOL.items()})
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0 if res["ok"] else 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in GATES:
        print("usage: python3 -m montecarlo_tpu_torch.validation "
              f"{{{','.join(GATES)}}} [--refuse-cache] [--out FILE]",
              file=sys.stderr)
        return 2
    return _gate(argv[0], argv[1:])


if __name__ == "__main__":
    sys.exit(main())
