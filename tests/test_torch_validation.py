"""The cross-safe_mult gate of the PyTorch/CUDA port
(montecarlo_tpu_torch/validation.py) on the CPU: the comparison semantics
of tests/test_validation_protocol.py against the port's compare_pools (and
the JAX package's on the same pools), the anchor cache and its one
defaults table, DQMC's sequence seeds, and a tiny pooled run.
"""

import json

import numpy as np
import pytest
import torch

from montecarlo_tpu.validation import compare_pools as j_compare_pools

import montecarlo_tpu_torch as tmc
from montecarlo_tpu_torch import validation as v
from montecarlo_tpu_torch.validation import compare_pools


def _pool(mean, se, n=64, ncomp=1, seed=0):
    """Per-chain sample pool with the requested mean / standard error."""
    rng = np.random.default_rng(seed)
    return mean + rng.standard_normal((n, ncomp)) * se * np.sqrt(n)


def _same_as_jax(a, b):
    out, ref = compare_pools(a, b), j_compare_pools(a, b)
    assert out == ref, (out, ref)
    return out


def test_statistical_pass_and_fail():
    ok, zs, tols = _same_as_jax(
        {"occ": _pool(0.5, 1e-3, seed=1)}, {"occ": _pool(0.5, 1e-3, seed=2)})
    assert ok and zs["occ"] < tols["occ"]
    # a 20-sigma bias must fail
    ok, zs, _ = _same_as_jax(
        {"occ": _pool(0.5 + 20 * np.sqrt(2) * 1e-3, 1e-3, seed=1)},
        {"occ": _pool(0.5, 1e-3, seed=2)})
    assert not ok and zs["occ"] > 10


def test_degenerate_component_absolute_gate():
    """A deterministic component (all chains identical) with a rounding-level
    difference between modes passes, a large absolute deviation fails."""
    a = {"sign": np.full((64, 1), 1.0)}
    b = {"sign": np.full((64, 1), 1.0 - 4e-5)}
    ok, zs, tols = _same_as_jax(a, b)
    assert ok, (zs, tols)
    c = {"sign": np.full((64, 1), 0.99)}
    ok, zs, tols = _same_as_jax(a, c)
    assert not ok
    rng = np.random.default_rng(7)
    a = {"sign": 1.0 + rng.standard_normal((64, 1)) * 1.2e-6 * 8}
    b = {"sign": (1.0 - 4.4e-5) + rng.standard_normal((64, 1)) * 1.2e-6 * 8}
    ok, zs, tols = _same_as_jax(a, b)
    assert ok, (zs, tols)


def test_bonferroni_scales_with_components():
    a = {"G": _pool(0.1, 1e-3, ncomp=4096, seed=3)}
    b = {"G": _pool(0.1, 1e-3, ncomp=4096, seed=4)}
    ok, zs, tols = _same_as_jax(a, b)
    assert ok
    assert tols["G"] > 5.0  # ~sqrt(2 ln(2*4096/0.01)) ≈ 5.2
    _, _, tols1 = _same_as_jax({"occ": _pool(0.5, 1e-3, seed=5)},
                               {"occ": _pool(0.5, 1e-3, seed=6)})
    assert tols1["occ"] < tols["G"]


def _fake_pooled_run(calls):
    """A pooled_run that records its arguments and returns a tiny pool."""
    def run(safe_mult=1, use_kernels=True, device="cuda", g_refresh=False,
            **overrides):
        calls.append(dict(overrides, safe_mult=safe_mult,
                          use_kernels=use_kernels, device=device))
        p = v.protocol(**overrides)
        n = p["n_chains"] * len(p["seeds"])
        return {"occ/occ": _pool(0.5, 1e-3, n=n, seed=safe_mult),
                "_acc": [0.5], "_perr_mean": [0.0], "_perr_hist": [[0] * 4]}
    return run


def test_anchor_cache_exists_key_roundtrip(tmp_path, monkeypatch):
    """anchor_cache_exists finds exactly the record cross_sm_check writes,
    candidate-only overrides leave the key alone, a differing protocol
    field, route or device misses; the record keeps its derived_at."""
    monkeypatch.setenv("MC_TORCH_ANCHOR_CACHE", str(tmp_path))
    calls = []
    monkeypatch.setattr(v, "pooled_run", _fake_pooled_run(calls))
    theta = np.arange(4.0).reshape(2, 2)
    kwargs = dict(L=2, beta=0.5, dtype="float32", use_kernels=False,
                  n_chains=3, sweeps=4, thermalization=2, peierls=theta,
                  observables=("occ",), device="cpu")
    assert not v.anchor_cache_exists(**kwargs)
    res = v.cross_sm_check(**kwargs)
    assert res["ok"] and not res["anchor_cached"]
    assert set(res["derived_at"]) == {"utc", "commit", "source"}
    assert [c["safe_mult"] for c in calls] == [10, 1]
    assert v.anchor_cache_exists(**kwargs)
    assert len(list(tmp_path.iterdir())) == 1
    assert v.anchor_cache_exists(cand_seeds=(1,), cand_sweeps=2,
                                 safe_mult=5, alpha=0.05, **kwargs)
    assert not v.anchor_cache_exists(**{**kwargs, "n_chains": 5})
    assert not v.anchor_cache_exists(**{**kwargs, "use_kernels": True})
    assert not v.anchor_cache_exists(**{**kwargs, "device": "cuda"})
    again = v.cross_sm_check(cand_sweeps=2, **kwargs)
    assert again["anchor_cached"] and len(calls) == 3
    assert again["derived_at"] == res["derived_at"]
    assert calls[2]["sweeps"] == 2 and calls[2]["safe_mult"] == 10
    live = v.cross_sm_check(refuse_cache=True, **kwargs)
    assert not live["anchor_cached"] and len(calls) == 5
    json.dumps({k: x for k, x in live.items() if not k.startswith("_")})


def test_anchor_key_from_one_defaults_table(tmp_path, monkeypatch):
    """The protocol defaults live in one table, PROTOCOL: a change there
    reaches the runs cross_sm_check makes and the cache key that
    anchor_cache_exists and the gate share; unknown fields raise."""
    monkeypatch.setenv("MC_TORCH_ANCHOR_CACHE", str(tmp_path))
    calls = []
    monkeypatch.setattr(v, "pooled_run", _fake_pooled_run(calls))
    assert v.PROTOCOL["seeds"] == (123, 321) and v.PROTOCOL["sweeps"] == 300
    cfg = v.anchor_config()
    assert {k: cfg[k] for k in v.PROTOCOL} == v.PROTOCOL
    assert (cfg["safe_mult"], cfg["use_kernels"], cfg["device"]) == (
        1, True, "cuda")
    monkeypatch.setitem(v.PROTOCOL, "n_chains", 2)
    monkeypatch.setitem(v.PROTOCOL, "observables", ("occ",))
    assert v.anchor_config()["n_chains"] == 2
    assert not v.anchor_cache_exists()
    v.cross_sm_check(device="cpu", use_kernels=False)
    assert all(v.protocol(**{k: c[k] for k in c if k in v.PROTOCOL})
               == v.PROTOCOL for c in calls)
    assert v.anchor_cache_exists(device="cpu", use_kernels=False)
    monkeypatch.setitem(v.PROTOCOL, "sweeps", 7)
    assert not v.anchor_cache_exists(device="cpu", use_kernels=False)
    with pytest.raises(TypeError, match="unknown protocol fields"):
        v.protocol(lattice=8)


@pytest.mark.parametrize("argv,kw", [
    (["refresh", "--refuse-cache"],
     dict(refuse_cache=True, safe_mult=v.REFRESH_SM, g_refresh=True)),
    (["refresh"], dict(refuse_cache=False, safe_mult=5, g_refresh=True)),
    (["headline"], dict(refuse_cache=False))])
def test_gate_command_line(monkeypatch, capsys, tmp_path, argv, kw):
    """python3 -m montecarlo_tpu_torch.validation {headline,refresh}: each
    gate calls cross_sm_check with its GATES keywords (refresh: bench.py's
    REFRESH_SM = 5 under g_refresh) and the protocol from PROTOCOL alone,
    so both gates share the anchor's cache key; it prints one JSON line
    with the gate's name, the protocol and the source digest, writes it to
    --out, and exits 1 where the gate fails. An unknown gate exits 2."""
    seen = []

    def fake_check(**k):
        seen.append(k)
        return {"ok": k.get("g_refresh", False), "z": {}, "_anchor_pool": {}}
    monkeypatch.setattr(v, "cross_sm_check", fake_check)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "card")
    monkeypatch.setattr(v.subprocess, "run", lambda *a, **k: type(
        "R", (), {"stdout": "card, 700.00 W\n"})())
    out = tmp_path / "gate.json"
    rc = v.main(argv + ["--out", str(out)])
    assert seen == [kw]
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["gate"] == argv[0] and rc == (0 if line["ok"] else 1)
    assert line["protocol"]["seeds"] == list(v.PROTOCOL["seeds"])
    assert line["source_digest"] == v.source_digest()
    assert json.loads(out.read_text()) == line
    assert "_anchor_pool" not in line
    # no gate touches a field of the anchor's key: one anchor for both
    assert not set(v.GATES[argv[0]]) & (set(v.PROTOCOL) | {
        "anchor_sm", "use_kernels", "anchor_use_kernels", "device"})
    assert v.main(["wrap"]) == 2


def _run(seed, n_chains=2):
    sim = tmc.DQMC(tmc.HubbardModelAttractive(dims=2, L=2, U=4.0, mu=0.3),
                   n_chains=n_chains, seed=seed, beta=1.0, safe_mult=5,
                   measure_rate=1, device="cpu", dtype=torch.float64)
    sim.run(thermalization=1, sweeps=2, verbose=False)
    return sim


def test_sequence_seed_concatenates_single_seed_runs():
    """DQMC(seed=(a, b)) is DQMC(seed=a) and DQMC(seed=b) side by side on
    the chain axis: the same configurations, per-chain observables within
    1e-10 and the same acceptance counts."""
    both, a, b = _run((11, 12)), _run(11), _run(12)
    assert both.n_chains == 4
    assert torch.equal(both.state["conf"],
                       torch.cat([a.state["conf"], b.state["conf"]]))
    assert both.analysis.acc_local == a.analysis.acc_local + b.analysis.acc_local
    assert both.analysis.acc_local > 0
    for key in ("occ", "greens"):
        out = both[key][key].per_chain_mean
        ref = np.concatenate([a[key][key].per_chain_mean,
                              b[key][key].per_chain_mean])
        assert np.max(np.abs(out - ref)) < 1e-10
    assert not torch.equal(a.state["conf"], b.state["conf"])


def test_tiny_pooled_run():
    """pooled_run on the CPU (L = 2, 2 + 2 sweeps, every default
    observable, CDS and PS included): len(seeds) × n_chains rows each."""
    out = v.pooled_run(safe_mult=5, use_kernels=True, device="cpu", L=2,
                       beta=1.0, dtype="float64", n_chains=3, sweeps=2,
                       thermalization=2, measure_rate=1, seeds=(1, 2))
    keys = {"occ/occ", "greens/greens", "CDC/cdc", "PC/pc", "SDCz/sdc_z",
            "CDS/cds", "PS/ps"}
    assert keys <= set(out)
    for k in keys:
        assert out[k].shape[0] == 6 and np.all(np.isfinite(out[k])), k
    assert out["PS/ps"].shape[2:] == (4, 4)          # (n_dirs, K, K)
    assert 0.0 < out["_acc"][0] < 1.0
    ok, zs, _ = compare_pools(out, out)
    assert ok and max(zs.values()) == 0.0
