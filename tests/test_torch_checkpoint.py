"""The port's checkpoint write half (``repro_torch.checkpoint``) against
the JAX package, on the CPU: checkpoints cross in both directions.

  · a port ``save_index`` of an index the JAX package built and saved
    (``opq``, ``sq8``, ``refine:pq:4``, namespace-filtered, and
    ``sparse=True`` with its BM25 impact plane), and of an index the port
    built, restores through the JAX package's ``restore_index`` leaf for
    leaf (``np.array_equal``, dtypes equal), with its tuned record: the
    reference restores by leaf index, so this holds the port's leaf
    order, not only its paths;
  · a JAX tuned ``save_index`` loads into the port, whose default-config
    ``Server`` serves the tuned widths: rows bit-identical to the port's
    direct search, and the reference server's rows up to near-tie swaps
    (scores within rtol=atol=1e-4, DESIGN.md §11);
  · a port ``save_mutable`` restores through the JAX package's
    ``restore_mutable`` leaf for leaf, and the two then mutate
    identically (delta lists, planes and tombstones after the same
    ``add_docs`` and ``delete_docs``);
  · ``CheckpointManager`` rotation, and ``restore_latest`` past a corrupt
    newest step.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.core import hybrid_index as jhi
from repro.core import segments as jseg
from repro.core.exec import frontier as jfrontier
from repro.data import synthetic
from repro.launch import serve as jserve
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import hybrid_index as hi
from repro_torch.core import segments as seg
from repro_torch.core.exec import frontier
from repro_torch.launch import serve

torch.set_num_threads(2)

TOL = 1e-4
SCORE_TOL = 1e-5
KW = dict(n_clusters=12, k1_terms=4, pq_m=4, pq_k=64, cluster_capacity=96,
          term_capacity=48, kmeans_iters=3)
N_NS = 3
HOLD = 48
DELTA = dict(delta_capacity=96, delta_cluster_capacity=8,
             delta_term_capacity=8)
TUNED = dict(kc=4, k2=6, refine_mult=None, recall_target=0.9, recall=0.91,
             cost=1000, rungs=((2, 4), (4, 6)), margin_cuts=(0.05,))
#: case → (codec, extra build arguments)
CASES = {"opq": ("opq", {}), "sq8": ("sq8", {}),
         "refine:pq:4": ("refine:pq:4", {}),
         "filtered": ("opq", {"doc_namespaces": True}),
         "sparse": ("opq", {"sparse": True})}


@pytest.fixture(scope="module")
def c():
    return synthetic.generate(seed=0, n_docs=1200, n_queries=16, hidden=32,
                              vocab_size=512, n_topics=8)


def _build_kw(c, extra):
    kw = dict(extra)
    if kw.pop("doc_namespaces", False):
        kw["doc_namespaces"] = np.arange(len(c.doc_emb)) % N_NS
    return kw


def _jbuild(c, codec, extra, seed=0):
    return jhi.build(jax.random.key(seed), jnp.asarray(c.doc_emb),
                     jnp.asarray(c.doc_tokens), c.vocab_size, codec=codec,
                     **KW, **_build_kw(c, extra))


def _jleaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _assert_leaves_equal(got, want):
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), p


@pytest.fixture(scope="module")
def jax_saved(c, tmp_path_factory):
    """case → (the JAX index with a tuned record attached, its save_index
    directory)."""
    out = {}
    for case, (codec, extra) in CASES.items():
        mult = 4 if codec.startswith("refine") else None
        tuned = jfrontier.TunedWidths(**dict(TUNED, refine_mult=mult))
        jidx = jhi.with_tuned(_jbuild(c, codec, extra), tuned)
        path = jckpt.save_index(str(tmp_path_factory.mktemp(
            case.replace(":", "_"))), 0, jidx)
        out[case] = (jidx, path)
    return out


# --------------------------------------------------------------------------
# port → JAX: save_index restores through the reference leaf for leaf
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_port_save_index_restores_in_the_reference(jax_saved, c, case,
                                                   tmp_path):
    jidx, jpath = jax_saved[case]
    idx = ckpt.load_index(jpath, device="cpu")
    assert idx.tuned == frontier.from_json(jfrontier.to_json(jidx.tuned))
    path = ckpt.save_index(str(tmp_path), 3, idx)
    assert os.path.basename(path) == "step_00000003"
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]
    mine, theirs = _manifest(path), _manifest(jpath)
    assert mine["leaves"] == theirs["leaves"]     # paths, order, shapes
    assert mine["extra"] == theirs["extra"]       # codec, filtered, tuned
    like = _jbuild(c, CASES[case][0], CASES[case][1], seed=1)
    assert like.tuned is None
    back = jckpt.restore_index(path, like)
    _assert_leaves_equal(_jleaves(back), _jleaves(jidx))
    assert back.tuned == jidx.tuned and back.codec == jidx.codec


def test_port_built_index_restores_in_the_reference(c, tmp_path):
    """An index the port built (sparse, filtered, tuned by apply_tuned's
    record) through the reference's restore_index: its leaves, in the
    reference's order, are the port's."""
    from repro_torch.launch import tune
    ns = np.arange(len(c.doc_emb)) % N_NS
    idx = hi.build(0, c.doc_emb, c.doc_tokens, c.vocab_size,
                   codec="refine:sq8:4", doc_namespaces=ns, sparse=True,
                   device="cpu", **KW)
    rec = frontier.TunedWidths(**dict(TUNED, refine_mult=2))
    idx = tune.apply_tuned(idx, rec)
    path = ckpt.save_index(str(tmp_path), 0, idx)
    like = jhi.build(jax.random.key(0), jnp.asarray(c.doc_emb),
                     jnp.asarray(c.doc_tokens), c.vocab_size,
                     codec="refine:sq8:2", doc_namespaces=ns, sparse=True,
                     **KW)
    back = jckpt.restore_index(path, like)
    want = [(p, t.numpy()) for p, t in hi.index_leaves(idx)]
    _assert_leaves_equal(_jleaves(back), want)
    assert tuple(back.tuned) == tuple(rec)
    assert _manifest(path)["extra"] == {
        "codec": "refine:sq8:2", "filtered": True,
        "tuned": frontier.to_json(rec)}


def test_port_restore_index_reads_by_leaf_index(jax_saved, c):
    """The port's restore_index fills ``like``'s structure by leaf index
    (as the reference does) and checks the codec and the shapes."""
    _, jpath = jax_saved["refine:pq:4"]
    want = ckpt.load_index(jpath, device="cpu")
    like = hi.build(1, c.doc_emb, c.doc_tokens, c.vocab_size,
                    codec="refine:pq:4", device="cpu", **KW)
    back = ckpt.restore_index(jpath, like)
    assert back.tuned == want.tuned and back.tuned is not None
    assert back.max_postings == want.max_postings
    for (p, x), (q, y) in zip(hi.index_leaves(back),
                              hi.index_leaves(want)):
        assert p == q and torch.equal(x, y), p
    with pytest.raises(ValueError, match="codec"):
        ckpt.restore_index(jpath, hi.build(1, c.doc_emb, c.doc_tokens,
                                           c.vocab_size, codec="opq",
                                           device="cpu", **KW))
    narrow = hi.build(1, c.doc_emb, c.doc_tokens, c.vocab_size,
                      codec="refine:pq:4", device="cpu",
                      **dict(KW, cluster_capacity=64))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_index(jpath, narrow)


# --------------------------------------------------------------------------
# JAX → port: a tuned checkpoint serves its tuned widths
# --------------------------------------------------------------------------

def _assert_topk_match(want, got):
    wi, ws = np.asarray(want.doc_ids), np.asarray(want.scores)
    gi, gs = got.doc_ids.numpy(), got.scores.numpy()
    np.testing.assert_array_equal(got.n_candidates.numpy(),
                                  np.asarray(want.n_candidates))
    np.testing.assert_allclose(gs, ws, rtol=TOL, atol=TOL)
    for b, p in zip(*np.nonzero(gi != wi)):
        where = np.flatnonzero(wi[b] == gi[b, p])
        ref = ws[b, where[0]] if where.size else ws[b, -1]
        assert abs(ref - gs[b, p]) <= TOL + TOL * abs(ref), (b, p)


@pytest.mark.parametrize("case", ["refine:pq:4", "sq8"])
def test_reference_tuned_checkpoint_serves_in_the_port(jax_saved, c, case):
    jidx, jpath = jax_saved[case]
    cfg = dict(top_r=20, max_batch=16)
    jserver = jserve.make_server(jidx, jserve.ServeConfig(**cfg))
    for server in (serve.Server.from_checkpoint(
                       jpath, cfg=serve.ServeConfig(**cfg), device="cpu"),
                   serve.Server.from_checkpoint(
                       jpath, ckpt.load_index(jpath, device="cpu"),
                       serve.ServeConfig(**cfg), device="cpu")):
        assert server.width_source == jserver.width_source == "tuned"
        assert (server.kc, server.k2) == (TUNED["kc"], TUNED["k2"])
        got = server.query(c.query_emb, c.query_tokens)
        direct = hi.search(server.index, c.query_emb, c.query_tokens,
                           kc=TUNED["kc"], k2=TUNED["k2"], top_r=20,
                           device="cpu")
        for x, y in zip((got.doc_ids, got.scores, got.n_candidates),
                        (direct.doc_ids, direct.scores,
                         direct.n_candidates)):
            assert torch.equal(x, y)
        _assert_topk_match(jserver.query(c.query_emb, c.query_tokens), got)


def test_load_index_attaches_the_manifest_record(jax_saved):
    _, jpath = jax_saved["opq"]
    idx = ckpt.load_index(jpath, device="cpu")
    assert idx.tuned.rungs == TUNED["rungs"]
    assert idx.tuned.margin_cuts == TUNED["margin_cuts"]
    # index.to() and dataclasses.replace carry the record along
    assert idx.to("cpu").tuned == idx.tuned
    assert hi.with_tuned(idx, None).tuned is None


# --------------------------------------------------------------------------
# mutable checkpoints: port save_mutable → reference restore_mutable
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_mut_saved(c, tmp_path_factory):
    """A port mutable index (namespaced, sparse, opq) after streaming and
    deletes, and its save_mutable directory."""
    ns = (np.arange(len(c.doc_emb)) % N_NS).astype(np.int32)
    mut = seg.MutableHybridIndex.create(
        5, c.doc_emb[:-2 * HOLD], c.doc_tokens[:-2 * HOLD], c.vocab_size,
        doc_namespaces=ns[:-2 * HOLD], codec="opq", sparse=True,
        device="cpu", **DELTA, **KW)
    ids = mut.add_docs(c.doc_emb[-2 * HOLD:-HOLD],
                       c.doc_tokens[-2 * HOLD:-HOLD],
                       namespaces=ns[-2 * HOLD:-HOLD])
    mut.delete_docs(np.r_[ids[:HOLD // 4], [1, 2, 9]])
    path = ckpt.save_mutable(str(tmp_path_factory.mktemp("mut")), 2, mut)
    return mut, path, ns


def _jlike_mut(c, ns):
    return jseg.MutableHybridIndex.create(
        jax.random.key(1), c.doc_emb[:-2 * HOLD], c.doc_tokens[:-2 * HOLD],
        c.vocab_size, doc_namespaces=ns[:-2 * HOLD], codec="opq",
        sparse=True, **DELTA, **KW)


def _port_state_leaves(mut):
    tree = dict(mut.state_tree(), key=ckpt.key_data(mut.seed))
    return [(p, x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))
            for p, x in hi.index_leaves(tree)]


def test_port_save_mutable_restores_in_the_reference(port_mut_saved, c):
    mut, path, ns = port_mut_saved
    jmut = jckpt.restore_mutable(path, _jlike_mut(c, ns))
    _assert_leaves_equal(_jleaves(jmut.state_tree()),
                         _port_state_leaves(mut))
    assert (jmut.delta_count, jmut.n_deleted, jmut.epoch) == (
        mut.delta_count, mut.n_deleted, mut.epoch)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jmut.key)), [0, mut.seed])
    extra = _manifest(path)["extra"]
    assert extra["codec"] == "opq" and extra["mutable"]["seed"] == 5
    # the port reads its own checkpoint back as it wrote it
    again = ckpt.load_mutable(path, seed=5, device="cpu")
    _assert_leaves_equal(_port_state_leaves(again), _port_state_leaves(mut))


def test_restored_mutable_index_mutates_as_the_port_does(port_mut_saved,
                                                         c):
    """The same add_docs and delete_docs on the port's index (read back
    from its checkpoint) and on the reference's restore of it: the same
    ids, delta lists (entries exact, eviction scores within 1e-5),
    planes and tombstones."""
    _, path, ns = port_mut_saved
    jmut = jckpt.restore_mutable(path, _jlike_mut(c, ns))
    tmut = ckpt.load_mutable(path, seed=5, device="cpu")
    args = (c.doc_emb[-HOLD:], c.doc_tokens[-HOLD:])
    ids = tmut.add_docs(*args, namespaces=ns[-HOLD:])
    np.testing.assert_array_equal(ids, jmut.add_docs(*args,
                                                     namespaces=ns[-HOLD:]))
    doomed = np.r_[ids[::5], [0, 11]]
    tmut.delete_docs(doomed)
    jmut.delete_docs(doomed)
    want, got = jmut.state_tree()["delta"], tmut.state_tree()["delta"]
    for k in ("cluster_entries", "cluster_lengths", "term_entries",
              "term_lengths", "assign", "ns", "emb", "tokens"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
    for k in ("cluster_scores", "term_scores"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                   rtol=SCORE_TOL, atol=SCORE_TOL)
    for k, v in want["planes"].items():
        np.testing.assert_array_equal(got["planes"][k], np.asarray(v), k)
    np.testing.assert_array_equal(tmut.tombstones, jmut.tombstones)
    assert (tmut.delta_count, tmut.epoch, tmut.dropped_postings) == (
        jmut.delta_count, jmut.epoch, jmut.dropped_postings)


def test_port_save_mutable_paths_are_the_reference_layout(c, tmp_path):
    """The manifest of a port save_mutable lists the reference
    save_mutable's leaf paths, in its order, with its shapes."""
    ns = (np.arange(len(c.doc_emb)) % N_NS).astype(np.int32)
    jmut = _jlike_mut(c, ns)
    jpath = jckpt.save_mutable(str(tmp_path / "ref"), 0, jmut)
    tmut = ckpt.load_mutable(jpath, seed=1, device="cpu")
    path = ckpt.save_mutable(str(tmp_path / "port"), 0, tmut)
    assert _manifest(path)["leaves"] == _manifest(jpath)["leaves"]


# --------------------------------------------------------------------------
# CheckpointManager
# --------------------------------------------------------------------------

def _tree(step):
    return {"w": torch.full((3, 2), float(step)),
            "opt": {"m": np.arange(4, dtype=np.int32) + step, "v": None}}


def test_manager_rotation_keeps_the_newest_steps(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2, save_every=10)
    assert mgr.latest_step() is None
    assert [s for s in range(35) if mgr.should_save(s)] == [10, 20, 30]
    for step in (10, 20, 30):
        mgr.save(step, _tree(step), extra={"note": step})
    assert mgr.steps() == [20, 30] and mgr.latest_step() == 30
    assert sorted(os.listdir(tmp_path)) == ["step_00000020",
                                            "step_00000030"]
    step, tree = mgr.restore_latest(_tree(0))
    assert step == 30
    assert torch.equal(tree["w"], torch.full((3, 2), 30.0))
    np.testing.assert_array_equal(tree["opt"]["m"], np.arange(4) + 30)
    assert tree["opt"]["v"] is None
    assert ckpt.load_manifest(mgr.path(30))["extra"] == {"note": 30}


def test_manager_restore_latest_skips_a_corrupt_newest_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=3)
    for step in (1, 2, 3):
        mgr.save(step, _tree(step))
    with open(os.path.join(mgr.path(3), "arrays.npz"), "wb") as f:
        f.write(b"truncated")
    os.makedirs(os.path.join(tmp_path, "step_00000004"))   # no manifest
    assert mgr.steps() == [1, 2, 3]
    step, tree = mgr.restore_latest(_tree(0))
    assert step == 2 and float(tree["w"][0, 0]) == 2.0
    # a target of another shape restores nothing
    wrong = {"w": torch.zeros(2, 2), "opt": {"m": np.zeros(4, np.int32),
                                             "v": None}}
    assert mgr.restore_latest(wrong) == (None, wrong)
