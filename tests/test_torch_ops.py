"""Each torch function of kubernetes_tpu_torch/ops against its jnp
counterpart in kubernetes_tpu/ops, on the same random inputs made from a
seed with numpy. Integer outputs match exactly; balanced_allocation_score
in float64 too (float32 as well: both sides do the same IEEE single
operations, and the result is truncated to an int)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import interpod as jip
from kubernetes_tpu.ops import noderesources as jnr
from kubernetes_tpu.ops import plugins as jpl
from kubernetes_tpu.ops import spread as jsp
from kubernetes_tpu_torch.ops import interpod as tip
from kubernetes_tpu_torch.ops import noderesources as tnr
from kubernetes_tpu_torch.ops import plugins as tpl
from kubernetes_tpu_torch.ops import spread as tsp

SEEDS = [0, 1, 2]
N = 300


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(port, ref):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_array_equal(port, ref.astype(port.dtype))
    return port


# -- noderesources -------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_fit_mask(seed):
    rng = np.random.default_rng(seed)
    k = 4
    alloc = rng.integers(0, 64_000, (k, N)).astype(np.int64)
    used = (alloc * rng.random((k, N))).astype(np.int64)
    req = rng.integers(0, 16_000, k).astype(np.int64)
    req[rng.integers(0, k)] = 0
    req_mask = req > 0
    pod_count = rng.integers(0, 12, N).astype(np.int32)
    max_pods = rng.integers(0, 12, N).astype(np.int32)
    got = _eq(
        tnr.fit_mask(_t(req), _t(req_mask), _t(alloc), _t(used), _t(pod_count), _t(max_pods)),
        jnr.fit_mask(req, req_mask, alloc, used, pod_count, max_pods),
    )
    assert got.any() and not got.all()


def _requested(seed):
    rng = np.random.default_rng(100 + seed)
    alloc = rng.integers(0, 256 * 1024**3, (2, N)).astype(np.int64)
    alloc[:, rng.integers(0, N, 20)] = 0
    requested = (alloc * rng.random((2, N)) * 1.2).astype(np.int64)
    requested[:, :5] = rng.integers(0, 1000, (2, 5))
    return requested, alloc


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("weights", [(1, 1), (3, 1), (0, 2)])
@pytest.mark.parametrize("strategy", ["least", "most", "rtc_up", "rtc_down"])
def test_scoring_strategies(seed, weights, strategy):
    requested, alloc = _requested(seed)
    w = np.asarray(weights, np.int64)
    if strategy == "least":
        got = tnr.least_allocated_score(_t(requested), _t(alloc), _t(w))
        want = jnr.least_allocated_score(requested, alloc, w)
    elif strategy == "most":
        got = tnr.most_allocated_score(_t(requested), _t(alloc), _t(w))
        want = jnr.most_allocated_score(requested, alloc, w)
    else:
        shape = ((0, 0), (50, 7), (100, 10)) if strategy == "rtc_up" else (
            (0, 10), (30, 8), (70, 3), (100, 0)
        )
        sx = np.asarray([p[0] for p in shape], np.int64)
        sy = np.asarray([p[1] for p in shape], np.int64)
        got = tnr.rtc_score(_t(requested), _t(alloc), _t(w), sx, sy)
        want = jnr.rtc_score(requested, alloc, w, jnp.asarray(sx), jnp.asarray(sy))
    assert got.dtype == torch.int64
    _eq(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("fdtype", ["float64", "float32"])
def test_balanced_allocation(seed, r, fdtype):
    rng = np.random.default_rng(200 + seed)
    alloc = rng.integers(0, 64_000, (r, N)).astype(np.int64)
    alloc[:, :7] = 0
    requested = (alloc * rng.random((r, N)) * 1.3).astype(np.int64)
    got = tnr.balanced_allocation_score(
        _t(requested), _t(alloc), fdtype=getattr(torch, fdtype)
    )
    assert got.dtype == torch.int32
    _eq(got, jnr.balanced_allocation_score(requested, alloc, fdtype=getattr(jnp, fdtype)))


def test_scoring_requested():
    rng = np.random.default_rng(3)
    nz_req = rng.integers(0, 4000, 2).astype(np.int64)
    nz_used = rng.integers(0, 64_000, (2, N)).astype(np.int64)
    _eq(
        tnr.scoring_requested(_t(nz_req), _t(nz_used)),
        jnr.scoring_requested(nz_req, nz_used),
    )


# -- plugins -------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("all_zero", [False, True])
def test_normalize_score(seed, reverse, all_zero):
    rng = np.random.default_rng(300 + seed)
    raw = rng.integers(0, 50, N).astype(np.int32)
    if all_zero:
        raw[:] = 0
    mask = rng.random(N) < 0.7
    _eq(
        tpl.normalize_score(_t(raw), _t(mask), reverse),
        jpl.normalize_score(raw, mask, reverse),
    )


@pytest.mark.parametrize("seed", SEEDS)
def test_ports_conflict_mask(seed):
    rng = np.random.default_rng(400 + seed)
    v = 16
    row = rng.random(v) < 0.3
    used = (rng.random((v, N)) < 0.1).astype(np.int32) * rng.integers(1, 3, (v, N)).astype(np.int32)
    got = _eq(tpl.ports_conflict_mask(_t(row), _t(used)), jpl.ports_conflict_mask(row, used))
    assert got.any() and not got.all()


# -- spread --------------------------------------------------------------


def _spread_tables(seed, d_pad=8, n_cls=4):
    rng = np.random.default_rng(500 + seed)
    j = 8
    dom = rng.integers(-1, 5, (j, N)).astype(np.int32)
    dom[1] = np.where(rng.random(N) < 0.1, -1, np.arange(N) % d_pad)
    spr = {
        "dom": dom,
        "elig": rng.random((j, N)) < 0.8,
        "max_skew": rng.integers(1, 4, j).astype(np.int32),
        "min_domains": np.where(rng.random(j) < 0.5, -1, rng.integers(1, 8, j)).astype(np.int32),
        "self_match": rng.random(j) < 0.5,
        "is_hostname": np.arange(j) % 3 == 1,
    }
    # class -> instance slots, -1 padded after the used prefix
    hard = np.full((n_cls, 2), -1, np.int32)
    soft = np.full((n_cls, 3), -1, np.int32)
    for c in range(1, n_cls):
        hard[c, : c % 3] = rng.choice(j, c % 3, replace=False)
        soft[c, : (c + 1) % 4] = rng.choice(j, (c + 1) % 4, replace=False)
    spr["hard"], spr["soft"] = hard, soft
    cnt = rng.integers(0, 4, (j, N)).astype(np.int32)
    return spr, cnt


def _port_spr(spr):
    out = dict(spr)
    out["dom"], out["elig"] = _t(spr["dom"]), _t(spr["elig"])
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_domain_aggregate(seed):
    spr, cnt = _spread_tables(seed)
    for j in range(spr["dom"].shape[0]):
        got = tsp._domain_aggregate(_t(spr["dom"][j]), _t(spr["elig"][j]), _t(cnt[j]), 8)
        want = jsp._domain_aggregate(spr["dom"][j], spr["elig"][j], cnt[j], 8)
        for g, w in zip(got, want):
            _eq(g, w)


@pytest.mark.parametrize("seed", SEEDS)
def test_hard_violations(seed):
    spr, cnt = _spread_tables(seed)
    for cls in range(spr["hard"].shape[0]):
        _eq(
            tsp.hard_violations(_port_spr(spr), _t(cnt), cls, 8),
            jsp.hard_violations(spr, cnt, cls, 8),
        )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fdtype", ["float64", "float32"])
def test_soft_scores(seed, fdtype):
    spr, cnt = _spread_tables(seed)
    mask = np.random.default_rng(600 + seed).random(N) < 0.8
    for cls in range(spr["soft"].shape[0]):
        got = tsp.soft_scores(
            _port_spr(spr), _t(cnt), cls, _t(mask), 8, fdtype=getattr(torch, fdtype)
        )
        assert got.dtype == torch.int32
        _eq(got, jsp.soft_scores(spr, cnt, cls, mask, 8, fdtype=getattr(jnp, fdtype)))


# -- interpod ------------------------------------------------------------


def _interpod_tables(seed, ident, d_pad=8, n_cls=5):
    rng = np.random.default_rng(700 + seed)
    ti, te = 8, 8
    if ident:
        # every valid node its own domain in every row (hostname terms)
        d_pad = 512

        def doms(t):
            return np.stack(
                [np.where(rng.random(N) < 0.1, -1, rng.permutation(N)) for _ in range(t)]
            ).astype(np.int32)
    else:

        def doms(t):
            return rng.integers(-1, 4, (t, N)).astype(np.int32)

    in_cnt = rng.integers(0, 3, (ti, N)).astype(np.int32)
    in_cnt[2] = 0  # no match anywhere: the first-pod special case
    ipa = {
        "in_dom": doms(ti),
        "ex_dom": doms(te),
        "in_pref_w": rng.integers(-100, 100, ti).astype(np.int32),
        "ex_anti": rng.random(te) < 0.5,
        "cls_req_aff": np.full((n_cls, 2), -1, np.int32),
        "cls_req_anti": np.full((n_cls, 2), -1, np.int32),
        "cls_pref": np.full((n_cls, 2), -1, np.int32),
    }
    ipa["cls_req_aff"][1, 0] = 2
    ipa["cls_req_aff"][2, :2] = [0, 3]
    ipa["cls_req_aff"][4, 0] = 5
    ipa["cls_req_anti"][3, :2] = [1, 4]
    ipa["cls_req_anti"][4, 0] = 6
    ipa["cls_pref"][2, 0] = 7
    ipa["cls_pref"][3, :2] = [0, 5]
    ex_cnt = (rng.random((te, N)) < 0.05).astype(np.int32)
    x = {
        "ipa_m_anti": rng.random(te) < 0.5,
        "ipa_m_w": rng.integers(-50, 50, te).astype(np.int32),
        "ipa_self_aff": np.bool_(True),
    }
    node_valid = rng.random(N) < 0.95
    return ipa, in_cnt, ex_cnt, x, node_valid, d_pad


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("ident", [False, True])
def test_interpod_domain_counts(seed, ident):
    ipa, in_cnt, _, _, _, d_pad = _interpod_tables(seed, ident)
    got = tip.domain_counts(_t(ipa["in_dom"]), _t(in_cnt), d_pad, ident)
    want = jip.domain_counts(ipa["in_dom"], in_cnt, d_pad, ident)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("ident", [False, True])
@pytest.mark.parametrize("score", [False, True])
def test_filter_and_score(seed, ident, score):
    ipa, in_cnt, ex_cnt, x, node_valid, d_pad = _interpod_tables(seed, ident)
    t_ipa = dict(ipa)
    for k in ("in_dom", "ex_dom", "ex_anti"):
        t_ipa[k] = _t(ipa[k])
    t_x = {k: torch.as_tensor(np.asarray(v)) for k, v in x.items()}
    for cls in range(ipa["cls_req_aff"].shape[0]):
        allowed, raw = tip.filter_and_score(
            t_ipa, _t(in_cnt), _t(ex_cnt), cls, t_x, d_pad, _t(node_valid),
            ident=ident, score=score,
        )
        w_allowed, w_raw = jip.filter_and_score(
            ipa, in_cnt, ex_cnt, cls, x, d_pad, node_valid, ident=ident, score=score,
        )
        assert raw.dtype == torch.int32
        _eq(allowed, w_allowed)
        _eq(raw, w_raw)


@pytest.mark.parametrize("seed", SEEDS)
def test_interpod_normalize(seed):
    rng = np.random.default_rng(800 + seed)
    raw = rng.integers(-500, 500, N).astype(np.int32)
    mask = rng.random(N) < 0.6
    _eq(tip.normalize(_t(raw), _t(mask)), jip.normalize(raw, mask))
    _eq(tip.normalize(_t(raw * 0 + 7), _t(mask)), jip.normalize(raw * 0 + 7, mask))


# -- the tie-break pick --------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_first_maximal_index(seed):
    """The "first" tie-break takes the first maximal index; torch.max over
    a dim, torch.argmax (on int32, since it takes no bool) and jnp.argmax
    agree on it."""
    rng = np.random.default_rng(900 + seed)
    score = rng.integers(-1, 4, N).astype(np.int32)
    _, idx = torch.max(_t(score), dim=0)
    want = int(jnp.argmax(score))
    assert int(idx) == want == int(np.flatnonzero(score == score.max())[0])
    csum = np.cumsum(score == score.max())
    rank = int(rng.integers(0, csum[-1]))
    assert int(torch.argmax(_t((csum > rank).astype(np.int32)))) == int(
        jnp.argmax(csum > rank)
    )
