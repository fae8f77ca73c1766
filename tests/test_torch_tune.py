"""The port's width tuner (``repro_torch.core.exec.frontier``,
``repro_torch.launch.tune``; DESIGN.md §14) against the JAX package on
the same seeded inputs, on the CPU.

  · ``pareto_frontier``, ``select``, ``resolve_rung`` and the
    ``to_json``/``from_json`` round trip give the reference's answers
    exactly; ``margins`` agree within 1e-12 and resolve equal rungs;
  · ``tune_index`` on small JAX-built indexes, loaded into the port
    through ``save_index``/``load_index`` (``opq``, and ``refine:pq:4``
    with multipliers 2, 4, 8): the same sweep points (kc, k2, cost and
    ``refine_mult`` exact, recall within 1e-12) and the same
    ``TunedWidths`` (every field exact, recall within 1e-12);
  · ``apply_tuned`` rewrites the refine spec over the same planes;
  · serving resolves widths explicit > tuned > default, and tuned-static
    serving is bit-identical to a direct search at the tuned widths.

The JAX indexes and both tunes run once per module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import hybrid_index as jhi
from repro.core.exec import frontier as jfrontier
from repro.data import synthetic
from repro.launch import tune as jtune
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import exec as qexec
from repro_torch.core import hybrid_index as hi
from repro_torch.core.exec import frontier
from repro_torch.launch import serve, tune

torch.set_num_threads(2)

RECALL_TOL = 1e-12
TOP_R = 50
ORACLE_WIDTH = 10
TARGET = 0.9
MULTS = (2, 4, 8)
_KW = dict(n_clusters=12, k1_terms=6, pq_m=4, pq_k=64,
           cluster_capacity=256, term_capacity=48, kmeans_iters=4)


@pytest.fixture(scope="module")
def c():
    return synthetic.generate(seed=0, n_docs=1800, n_queries=48, hidden=32,
                              vocab_size=512, n_topics=12, sigma_doc=0.18)


@pytest.fixture(scope="module")
def tuned_pair(c, tmp_path_factory):
    """codec → (JAX index, port index, reference (tuned, points), port
    (tuned, points), oracle); each JAX index reaches the port through a
    reference save_index checkpoint."""
    oracle = jtune.exact_oracle(c.doc_emb, c.query_emb, ORACLE_WIDTH)
    out = {}
    for codec in ("opq", "refine:pq:4"):
        jidx = jhi.build(jax.random.key(0), jnp.asarray(c.doc_emb),
                         jnp.asarray(c.doc_tokens), c.vocab_size,
                         codec=codec, **_KW)
        path = jckpt.save_index(str(tmp_path_factory.mktemp("tune")), 0,
                                jidx)
        idx = ckpt.load_index(path, device="cpu")
        kw = dict(recall_target=TARGET, top_r=TOP_R, refine_mults=MULTS)
        ref = jtune.tune_index(jidx, c.query_emb, c.query_tokens, oracle,
                               **kw)
        got = tune.tune_index(idx, c.query_emb, c.query_tokens, oracle,
                              device="cpu", **kw)
        out[codec] = (jidx, idx, ref, got, oracle)
    return out


# --------------------------------------------------------------------------
# frontier primitives against the reference's
# --------------------------------------------------------------------------

def _points(rng, n=40):
    """Random sweep points with repeated costs and recalls (ties)."""
    return [frontier.SweepPoint(int(rng.integers(1, 13)),
                                int(rng.integers(1, 17)),
                                float(rng.integers(0, 8)) / 8,
                                float(rng.integers(1, 6) * 100),
                                refine_mult=[None, 2, 4][i % 3])
            for i in range(n)]


def _as_ref(points):
    return [jfrontier.SweepPoint(*p) for p in points]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pareto_frontier_and_select_equal_the_reference(seed):
    pts = _points(np.random.default_rng(seed))
    assert ([tuple(p) for p in frontier.pareto_frontier(pts)]
            == [tuple(p) for p in jfrontier.pareto_frontier(_as_ref(pts))])
    for target in (0.0, 0.3, 0.5, 0.875, 0.99):
        assert (tuple(frontier.select(pts, target))
                == tuple(jfrontier.select(_as_ref(pts), target)))
    with pytest.raises(ValueError):
        frontier.select([], 0.9)


def test_resolve_rung_equals_the_reference():
    m = np.random.default_rng(3).random(200) * 0.4
    m[:4] = (0.3, 0.1, 0.0, 0.4)         # exact ties at the cuts
    for cuts in ((), (0.2,), (0.3, 0.1), (0.35, 0.2, 0.05)):
        np.testing.assert_array_equal(frontier.resolve_rung(m, cuts),
                                      jfrontier.resolve_rung(m, cuts))


def test_tuned_widths_json_round_trip_equals_the_reference():
    rec = dict(kc=4, k2=6, refine_mult=2, recall_target=0.95,
               recall=0.957, cost=3024, rungs=((1, 2), (4, 6)),
               margin_cuts=(0.214282,))
    for fields in (rec, dict(rec, refine_mult=None, rungs=((4, 6),),
                             margin_cuts=())):
        mine = frontier.TunedWidths(**fields)
        ref = jfrontier.TunedWidths(**fields)
        assert frontier.to_json(mine) == jfrontier.to_json(ref)
        assert frontier.from_json(frontier.to_json(mine)) == mine
        assert tuple(frontier.from_json(jfrontier.to_json(ref))) == \
            tuple(ref)
    assert frontier.WIDTH_GRID == jfrontier.WIDTH_GRID
    assert frontier.IVF_KC_GRID == jfrontier.IVF_KC_GRID
    assert qexec.TunedWidths is frontier.TunedWidths


@pytest.mark.parametrize("scale", [1.0, 4.0, 37.0])
def test_margins_equal_the_reference_and_resolve_equal_rungs(scale):
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(24, 16)).astype(np.float32)
    q = (scale * rng.normal(size=(64, 16))).astype(np.float32)
    q[0] = 0.0                                        # zero vector
    want = jfrontier.margins(jnp.asarray(emb), q)
    for emb_in in (torch.from_numpy(emb), emb, emb.astype(np.float64)):
        got = frontier.margins(emb_in, torch.from_numpy(q))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        cuts = (float(np.median(want)), float(np.quantile(want, 0.2)))
        np.testing.assert_array_equal(frontier.resolve_rung(got, cuts),
                                      jfrontier.resolve_rung(want, cuts))
    assert frontier.margins(emb[:1], q).tolist() == [0.0] * 64


# --------------------------------------------------------------------------
# tune_index against the reference's on the same index and queries
# --------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["opq", "refine:pq:4"])
def test_tune_index_gives_the_reference_points(tuned_pair, codec):
    _, _, (_, want), (_, got), _ = tuned_pair[codec]
    assert len(got) == len(want) == len(frontier.WIDTH_GRID) * (
        len(MULTS) if codec.startswith("refine") else 1)
    for g, w in zip(got, want):
        assert (g.kc, g.k2, g.cost, g.refine_mult) == (
            w.kc, w.k2, w.cost, w.refine_mult)
        assert abs(g.recall - w.recall) <= RECALL_TOL


@pytest.mark.parametrize("codec", ["opq", "refine:pq:4"])
def test_tune_index_selects_the_reference_record(tuned_pair, codec):
    _, _, (want, _), (got, _), _ = tuned_pair[codec]
    assert (got.kc, got.k2, got.refine_mult, got.cost, got.rungs,
            got.margin_cuts, got.recall_target) == (
        want.kc, want.k2, want.refine_mult, want.cost, want.rungs,
        want.margin_cuts, want.recall_target)
    assert abs(got.recall - want.recall) <= RECALL_TOL
    assert got.rungs[-1] == (got.kc, got.k2)
    assert len(got.margin_cuts) == len(got.rungs) - 1


def test_per_query_recall_equals_the_reference(tuned_pair, c):
    jidx, idx, _, _, oracle = tuned_pair["opq"]
    res = hi.search(idx, c.query_emb, c.query_tokens, kc=2, k2=4,
                    top_r=TOP_R, device="cpu")
    jres = jhi.search(jidx, jnp.asarray(c.query_emb),
                      jnp.asarray(c.query_tokens), kc=2, k2=4, top_r=TOP_R)
    np.testing.assert_allclose(
        tune.per_query_recall(res.doc_ids, oracle, TOP_R),
        jtune.per_query_recall(jres.doc_ids, oracle, TOP_R),
        rtol=0, atol=RECALL_TOL)
    np.testing.assert_array_equal(
        tune.exact_oracle(c.doc_emb, c.query_emb, ORACLE_WIDTH), oracle)


def test_apply_tuned_rewrites_the_refine_spec_over_the_same_planes(
        tuned_pair):
    _, idx, (want, _), (got, _), _ = tuned_pair["refine:pq:4"]
    out = tune.apply_tuned(idx, got)
    ref = jtune.apply_tuned(tuned_pair["refine:pq:4"][0], want)
    assert out.codec == ref.codec == f"refine:pq:{got.refine_mult}"
    assert out.tuned == got
    assert all(out.doc_planes[k] is idx.doc_planes[k]
               for k in idx.doc_planes)
    assert tune._with_mult("refine", 8) == jtune._with_mult("refine", 8)
    assert tune._spec_for("opq", None) == "opq"
    # a codec without a multiplier keeps its spec
    _, oidx, _, (otuned, opts), _ = tuned_pair["opq"]
    assert otuned.refine_mult is None
    assert tune.apply_tuned(oidx, otuned).codec == "opq"


# --------------------------------------------------------------------------
# serving: explicit > tuned > default; tuned-static is a direct search
# --------------------------------------------------------------------------

def test_serve_width_resolution_order(tuned_pair):
    _, idx, _, (tuned, _), _ = tuned_pair["refine:pq:4"]
    tuned_idx = tune.apply_tuned(idx, tuned)
    cfg = serve.ServeConfig(top_r=20, max_batch=8)
    assert serve.resolve_widths(cfg, idx) == (
        serve.DEFAULT_KC, serve.DEFAULT_K2, "default")
    assert serve.resolve_widths(cfg, tuned_idx) == (tuned.kc, tuned.k2,
                                                    "tuned")
    # a partial explicit fills the gap from the tuned record
    assert serve.resolve_widths(serve.ServeConfig(kc=5), tuned_idx) == (
        5, tuned.k2, "explicit")
    assert serve.resolve_widths(serve.ServeConfig(kc=5), idx) == (
        5, serve.DEFAULT_K2, "explicit")
    s_tuned = serve.make_server(tuned_idx, serve.ServeConfig(
        adaptive=True, top_r=20, max_batch=8), device="cpu")
    assert (s_tuned.kc, s_tuned.k2, s_tuned.width_source) == (
        tuned.kc, tuned.k2, "tuned")
    if len(tuned.rungs) > 1:
        assert s_tuned.rungs == tuned.rungs
        assert s_tuned.margin_cuts == tuned.margin_cuts
    s_exp = serve.make_server(tuned_idx, serve.ServeConfig(
        adaptive=True, kc=6, k2=8, top_r=20, max_batch=8), device="cpu")
    assert s_exp.width_source == "explicit"
    assert s_exp.rungs == ((6, 8),) and s_exp.margin_cuts == ()
    s_static = serve.make_server(tuned_idx, serve.ServeConfig(
        top_r=20, max_batch=8), device="cpu")
    assert s_static.rungs == ((tuned.kc, tuned.k2),)
    # a two-rung record: the ladder engages only with adaptive=True
    ladder = tuned._replace(
        rungs=((1, 2), (tuned.kc, tuned.k2)), margin_cuts=(0.1,))
    lidx = hi.with_tuned(idx, ladder)
    assert serve.make_server(lidx, serve.ServeConfig(adaptive=True),
                             device="cpu").rungs == ladder.rungs
    assert serve.make_server(lidx, serve.ServeConfig(),
                             device="cpu").margin_cuts == ()


def test_tuned_widths_serve_bit_identical_to_direct_search(tuned_pair, c):
    _, idx, _, (tuned, _), _ = tuned_pair["refine:pq:4"]
    tuned_idx = tune.apply_tuned(idx, tuned)
    server = serve.make_server(tuned_idx, serve.ServeConfig(
        top_r=20, max_batch=8), device="cpu")
    got = server.query(c.query_emb[:8], c.query_tokens[:8])
    ref = hi.search(tuned_idx, c.query_emb[:8], c.query_tokens[:8],
                    kc=tuned.kc, k2=tuned.k2, top_r=20, device="cpu")
    assert torch.equal(got.doc_ids, ref.doc_ids)
    assert torch.equal(got.scores, ref.scores)
    assert torch.equal(got.n_candidates, ref.n_candidates)


def test_tune_cli_saves_a_tuned_checkpoint(tmp_path, capsys):
    tune.main(["--device", "cpu", "--docs", "1200", "--queries", "32",
               "--codec", "refine:pq:4", "--refine-mults", "2", "4",
               "--top-r", "20", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "tuned: kc=" in out and "saved tuned index checkpoint" in out
    loaded = ckpt.load_index(str(tmp_path / "step_00000000"), device="cpu")
    assert loaded.tuned is not None
    assert loaded.codec == f"refine:pq:{loaded.tuned.refine_mult}"
