"""Port parity of the recsys family: ``repro_torch.models.recsys`` (with
``layers.layernorm``), ``repro_torch.data.recsys``,
``repro_torch.configs`` and ``repro_torch.examples.recsys_retrieval``
against the live JAX package, on the CPU.

Each family runs at its ``make_reduced()`` config on parameters the
reference initialises, carried across by
``checkpoint.recsys_params_from_numpy``, and on the reference data
generators' batches (with PAD_ID added to exercise the masks).  SASRec's
attention takes the flash kernel's plain version here; the reference runs
its chunked XLA path.

Tolerance: rtol = atol = 1e-4 (f32; the two frameworks sum matmuls and
reductions in different orders).  Retrieval ids are exact except for
swaps between positions whose reference scores lie within that
tolerance; constructed ties go to the lower position on both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import registry as jregistry
from repro.configs import shapes as jshapes
from repro.core import hybrid_index as jhi
from repro.core.codecs import flat as jflat
from repro.data import recsys as jdata
from repro.models import layers as jlayers
from repro.models import recsys as jrec
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import registry, shapes
from repro_torch.data import recsys as rdata
from repro_torch.examples import recsys_retrieval as example
from repro_torch.models import layers, recsys

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCHS = ("dlrm-rm2", "sasrec", "dien", "mind")
_INIT = {"dlrm-rm2": jrec.dlrm_init, "sasrec": jrec.sasrec_init,
         "dien": jrec.dien_init, "mind": jrec.mind_init}


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def _carried(arch: str, seed: int = 0, cfg=None):
    """(reduced cfg, reference params, the port's params from them)."""
    cfg = cfg or jregistry.get(arch).make_reduced()
    jparams = _INIT[arch](jax.random.key(seed), cfg)
    leaves = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
              jax.tree_util.tree_flatten_with_path(jparams)[0]}
    params = ckpt.recsys_params_from_numpy(arch, leaves, _port_cfg(cfg),
                                           device="cpu")
    return cfg, jparams, params


def _port_cfg(cfg):
    """The port's config dataclass with the reference config's fields."""
    cls = getattr(recsys, type(cfg).__name__)
    return cls(**dataclasses.asdict(cfg))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _ids_match(got_s, got_i, want_s, want_i) -> None:
    """Ids equal except swaps between positions whose reference scores
    lie within TOL; scores within TOL."""
    got_s, got_i = got_s.numpy(), got_i.numpy()
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    np.testing.assert_allclose(got_s, want_s, **TOL)
    for row in range(want_i.shape[0]):
        diff = np.nonzero(got_i[row] != want_i[row])[0]
        for j in diff:
            near = np.abs(want_s[row] - want_s[row, j]) <= (
                TOL["atol"] + TOL["rtol"] * abs(want_s[row, j]))
            assert got_i[row, j] in set(want_i[row][near]) | set(
                got_i[row][near]), (row, j)


def _with_pads(ids: np.ndarray, n_pad: int) -> np.ndarray:
    """Left-pad the first rows with PAD_ID (row i gets i·n_pad pads, the
    last row none), as a short history arrives."""
    ids = ids.copy()
    for i in range(min(ids.shape[0] - 1, 3)):
        ids[i, :min((i + 1) * n_pad, ids.shape[1] - 1)] = jrec.PAD_ID
    return ids


# --------------------------------------------------------------------------
# substrate
# --------------------------------------------------------------------------

def test_layernorm_matches_the_reference():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 16)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=16).astype(np.float32),
         "bias": rng.normal(size=16).astype(np.float32)}
    _close(layers.layernorm({k: _t(v) for k, v in p.items()}, _t(x)),
           jlayers.layernorm({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x)))
    init = layers.layernorm_init(16)
    ref = jlayers.layernorm_init(16)
    for k in ("scale", "bias"):
        np.testing.assert_array_equal(init[k].numpy(), np.asarray(ref[k]))
    # bf16 in, bf16 out, computed in f32
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = layers.layernorm({k: _t(v) for k, v in p.items()}, xb)
    assert got.dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_the_reference(mode):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(50, 8)).astype(np.float32)
    ids = rng.integers(0, 50, (4, 3, 6)).astype(np.int32)
    ids[0, 0, 2:] = jrec.PAD_ID
    ids[1, 2, :] = jrec.PAD_ID                   # an empty bag
    got = recsys.embedding_bag(_t(table), _t(ids), mode)
    _close(got, jrec.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                                   mode))
    assert float(got[1, 2].abs().max()) == 0.0


def test_embedding_bag_ragged_matches_the_reference():
    rng = np.random.default_rng(2)
    table = rng.normal(size=(40, 8)).astype(np.float32)
    flat_ids = rng.integers(0, 40, 23).astype(np.int32)
    flat_ids[[3, 9, 10]] = jrec.PAD_ID
    # bags of 5, 0, 7, 11 ids: an empty bag in the middle
    offsets = np.array([0, 5, 5, 12], np.int32)
    got = recsys.embedding_bag_ragged(_t(table), _t(flat_ids), _t(offsets),
                                      4)
    want = jrec.embedding_bag_ragged(jnp.asarray(table),
                                     jnp.asarray(flat_ids),
                                     jnp.asarray(offsets), 4)
    _close(got, want)
    # row order: bag 3 is the plain left-to-right sum of its rows
    rows = torch.from_numpy(table[flat_ids[12:]])
    want3 = torch.zeros(8)
    for r in rows:
        want3 = want3 + r
    assert torch.equal(got[3], want3)


def test_top_k_breaks_ties_to_the_lower_position():
    scores = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 2.0, -1.0, 3.0],
                       [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    got_s, got_i = recsys.top_k(_t(scores), 5)
    want_s, want_i = jax.lax.top_k(jnp.asarray(scores), 5)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_i[0].tolist() == [1, 2, 4, 7, 3]


# --------------------------------------------------------------------------
# data generators, configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,args,rows", [
    ("dlrm_batch", (3, 17), "n_rows"), ("sasrec_batch", (4, 9), "n_items"),
    ("dien_batch", (5, 11), "n_items"), ("mind_batch", (6, 7), "n_items")])
def test_data_generators_are_bitwise_equal(name, args, rows):
    got = getattr(rdata, name)(*args, **{rows: 5_000}, device="cpu")
    want = getattr(jdata, name)(*args, **{rows: 5_000})
    assert got._fields == want._fields
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def _fields(cfg) -> dict:
    """A config's fields, dtypes by name (torch's and numpy's differ as
    objects)."""
    return {k: (str(v).split(".")[-1] if isinstance(v, torch.dtype)
                else getattr(v, "__name__", v))
            for k, v in dataclasses.asdict(cfg).items()}


def test_registry_and_shapes_match_the_reference_field_for_field():
    ported = registry.all_archs()
    ref = jregistry.all_archs()
    assert sorted(ported) == sorted(ref) == [
        "dien", "dlrm-rm2", "gatedgcn", "hi2-synth", "internlm2-1.8b",
        "llama3-8b", "mind", "mixtral-8x22b", "olmoe-1b-7b", "sasrec",
        "stablelm-3b"]
    for aid, arch in ported.items():
        want = ref[aid]
        for field in ("arch_id", "family", "source", "skip_shapes",
                      "extra"):
            assert getattr(arch, field) == getattr(want, field), (aid, field)
        assert _fields(arch.make_config()) == _fields(want.make_config()), aid
        assert _fields(arch.make_reduced()) == _fields(
            want.make_reduced()), aid
        assert type(arch.make_config()).__name__ == type(
            want.make_config()).__name__
        assert list(arch.shapes) == list(want.shapes), aid
        for name, shape in arch.shapes.items():
            assert type(shape).__name__ == type(want.shapes[name]).__name__
            assert (dataclasses.asdict(shape)
                    == dataclasses.asdict(want.shapes[name])), (aid, name)
    for extra in (False, True):
        for skipped in (False, True):
            assert registry.cells(skipped, extra) == jregistry.cells(
                skipped, extra)
    assert ("llama3-8b", "train_4k") in registry.cells()
    assert ("llama3-8b", "long_500k") not in registry.cells()
    for table in ("LM_SHAPES", "GNN_SHAPES", "REC_SHAPES"):
        got, want = getattr(shapes, table), getattr(jshapes, table)
        assert {k: dataclasses.asdict(v) for k, v in got.items()} == {
            k: dataclasses.asdict(v) for k, v in want.items()}
    assert shapes.pad_to_multiple(30_522, 16) == jshapes.pad_to_multiple(
        30_522, 16)


def test_recsys_params_from_numpy_checks_the_layout():
    cfg, jparams, params = _carried("sasrec")
    assert params["blocks"]["attn"]["wq"]["w"].shape == (
        cfg.n_blocks, cfg.embed_dim, cfg.embed_dim)
    leaves = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
              jax.tree_util.tree_flatten_with_path(jparams)[0]}
    port_cfg = _port_cfg(cfg)
    with pytest.raises(ValueError, match="shape"):
        ckpt.recsys_params_from_numpy(
            "sasrec", leaves, dataclasses.replace(port_cfg, n_items=7),
            device="cpu")
    with pytest.raises(KeyError, match="keys"):
        ckpt.recsys_params_from_numpy(
            "sasrec", {k: v for k, v in leaves.items()
                       if "final_norm" not in k}, port_cfg, device="cpu")
    with pytest.raises(ValueError, match="recsys arch"):
        ckpt.recsys_params_from_numpy("llama3-8b", leaves, port_cfg,
                                      device="cpu")
    _, _, dlrm = _carried("dlrm-rm2")
    assert isinstance(dlrm["bot"], list) and set(dlrm["bot"][0]) == {"w",
                                                                    "b"}


# --------------------------------------------------------------------------
# the four families: serve and retrieval
# --------------------------------------------------------------------------

def test_dlrm_forward_and_retrieval_match_the_reference():
    cfg, jparams, params = _carried("dlrm-rm2")
    jb = jdata.dlrm_batch(0, 16, n_sparse=cfg.n_sparse, n_rows=cfg.n_rows)
    sparse = np.asarray(jb.sparse).copy()
    sparse[0, 1] = jrec.PAD_ID                   # PAD reads row 0
    jb = jb._replace(sparse=jnp.asarray(sparse))
    tb = recsys.DLRMBatch(*(_t(a) for a in jb))
    _close(recsys.dlrm_forward(params, _port_cfg(cfg), tb),
           jrec.dlrm_forward(jparams, cfg, jb))
    cands = np.arange(cfg.n_rows, dtype=np.int32)[::-1].copy()
    got = recsys.dlrm_retrieval(params, _port_cfg(cfg),
                                _t(np.asarray(jb.dense)[:1]),
                                _t(sparse[1, :-1]), _t(cands), top_r=20)
    want = jrec.dlrm_retrieval(jparams, cfg, jb.dense[:1],
                               jnp.asarray(sparse[1, :-1]),
                               jnp.asarray(cands), top_r=20)
    _ids_match(*got, *want)


def test_sasrec_user_embedding_and_retrieval_match_the_reference():
    cfg, jparams, params = _carried("sasrec")
    jb = jdata.sasrec_batch(0, 6, seq_len=cfg.seq_len, n_items=cfg.n_items)
    items = _with_pads(np.asarray(jb.items), 3)
    _close(recsys.sasrec_hidden(params, _port_cfg(cfg), _t(items)),
           jrec.sasrec_hidden(jparams, cfg, jnp.asarray(items)))
    _close(recsys.sasrec_user_embedding(params, _port_cfg(cfg), _t(items)),
           jrec.sasrec_user_embedding(jparams, cfg, jnp.asarray(items)))
    for row in (0, 5):
        got = recsys.sasrec_retrieval(params, _port_cfg(cfg),
                                      _t(items[row:row + 1]), top_r=25)
        want = jrec.sasrec_retrieval(jparams, cfg,
                                     jnp.asarray(items[row:row + 1]),
                                     top_r=25)
        _ids_match(*got, *want)


def test_sasrec_retrieval_ties_go_to_the_lower_item_id():
    """Items i and i + n/2 share one embedding row: every score ties, and
    both sides rank the lower id first."""
    cfg, jparams, params = _carried("sasrec")
    table = np.asarray(jparams["item_embed"]["table"]).copy()
    half = cfg.n_items // 2
    table[half:] = table[:half]
    jparams = dict(jparams, item_embed={"table": jnp.asarray(table)})
    params = dict(params, item_embed={"table": _t(table)})
    items = np.asarray(jdata.sasrec_batch(1, 1, seq_len=cfg.seq_len,
                                          n_items=cfg.n_items).items)
    got_s, got_i = recsys.sasrec_retrieval(params, _port_cfg(cfg),
                                           _t(items), top_r=20)
    want_s, want_i = jrec.sasrec_retrieval(jparams, cfg, jnp.asarray(items),
                                           top_r=20)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    ids = got_i[0].tolist()
    assert all(ids[j + 1] == ids[j] + half for j in range(0, 20, 2))


def test_dien_forward_and_retrieval_match_the_reference():
    cfg, jparams, params = _carried("dien")
    jb = jdata.dien_batch(0, 8, seq_len=cfg.seq_len, n_items=cfg.n_items)
    hist = _with_pads(np.asarray(jb.history), 4)
    hist[3, :] = jrec.PAD_ID                     # no history at all
    jb = jb._replace(history=jnp.asarray(hist))
    tb = recsys.DIENBatch(*(_t(a) for a in jb))
    _close(recsys.dien_forward(params, _port_cfg(cfg), tb),
           jrec.dien_forward(jparams, cfg, jb))
    cands = np.random.default_rng(3).permutation(cfg.n_items)[:300].astype(
        np.int32)
    for row in (0, 5):
        got = recsys.dien_retrieval(params, _port_cfg(cfg),
                                    _t(hist[row:row + 1]), _t(cands),
                                    top_r=30)
        want = jrec.dien_retrieval(jparams, cfg,
                                   jnp.asarray(hist[row:row + 1]),
                                   jnp.asarray(cands), top_r=30)
        _ids_match(*got, *want)


def test_mind_interests_and_retrieval_match_the_reference():
    cfg, jparams, params = _carried("mind")
    jb = jdata.mind_batch(0, 6, seq_len=cfg.seq_len, n_items=cfg.n_items)
    hist = _with_pads(np.asarray(jb.history), 2)
    _close(recsys.mind_interests(params, _port_cfg(cfg), _t(hist)),
           jrec.mind_interests(jparams, cfg, jnp.asarray(hist)))
    for row in (0, 4):
        got = recsys.mind_retrieval(params, _port_cfg(cfg),
                                    _t(hist[row:row + 1]), top_r=25)
        want = jrec.mind_retrieval(jparams, cfg,
                                   jnp.asarray(hist[row:row + 1]), top_r=25)
        _ids_match(*got, *want)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_the_reference_layout(arch):
    """The port's init gives the reference's leaf paths, shapes and
    dtypes, and its distributions' scales."""
    cfg = jregistry.get(arch).make_reduced()
    jparams = _INIT[arch](jax.random.key(0), cfg)
    init = {"dlrm-rm2": recsys.dlrm_init, "sasrec": recsys.sasrec_init,
            "dien": recsys.dien_init, "mind": recsys.mind_init}[arch]
    params = init(torch.Generator().manual_seed(0), _port_cfg(cfg))

    def paths(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in paths(v, f"{prefix}['{k}']").items()}
        if isinstance(tree, list):
            return {k2: v2 for i, v in enumerate(tree)
                    for k2, v2 in paths(v, f"{prefix}[{i}]").items()}
        return {prefix: tree}

    want = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = paths(params)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert got[path].numpy().dtype == w.dtype, path
        if w.size >= 500:        # the draw's scale, within sampling error
            np.testing.assert_allclose(float(got[path].std()),
                                       float(w.std()), rtol=0.2)
        elif not w.any():
            assert not bool(got[path].any()), path


# --------------------------------------------------------------------------
# the example: HI² over the SASRec item tower
# --------------------------------------------------------------------------

def test_recsys_retrieval_example_on_the_reference_index(tmp_path, capsys):
    """The reference example's recipe at its size: the JAX-built index,
    read through save_index / load_index, searched with the port's users
    gives the reference's ids and n_candidates; then the port's own
    ``main`` runs and prints its line."""
    n, d = example.N_ITEMS, example.EMBED_DIM
    cfg = jrec.SASRecConfig(n_items=n, embed_dim=d, seq_len=example.SEQ_LEN)
    jparams = jrec.sasrec_init(jax.random.key(0), cfg)
    table = np.asarray(jparams["item_embed"]["table"])
    tokens, cats, brand = example.item_tokens(n, example.VOCAB)
    jindex = jhi.build(jax.random.key(1), jnp.asarray(table),
                       jnp.asarray(tokens), example.VOCAB,
                       n_clusters=example.N_CLUSTERS,
                       k1_terms=example.K1_TERMS, codec="flat",
                       cluster_capacity=example.CLUSTER_CAP,
                       term_capacity=example.TERM_CAP,
                       kmeans_iters=example.KMEANS_ITERS)
    jb = jdata.sasrec_batch(0, example.N_USERS, seq_len=cfg.seq_len,
                            n_items=n)
    jusers = jrec.sasrec_user_embedding(jparams, cfg, jb.items)
    q_tokens = example.query_tokens(np.asarray(jb.items), cats, brand)
    jres = jhi.search(jindex, jusers, jnp.asarray(q_tokens),
                      kc=example.KC, k2=example.K2, top_r=example.TOP_R)
    _, jexact = jflat.search(jusers, jnp.asarray(table), k=example.TOP_R)

    index = ckpt.load_index(jckpt.save_index(str(tmp_path), 0, jindex),
                            device="cpu")
    leaves = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
              jax.tree_util.tree_flatten_with_path(jparams)[0]}
    params = ckpt.recsys_params_from_numpy("sasrec", leaves, _port_cfg(cfg),
                                           device="cpu")
    out = example.run(params, _port_cfg(cfg), torch.device("cpu"),
                      n_clusters=example.N_CLUSTERS,
                      n_users=example.N_USERS, index=index)
    _close(out["users"], jusers)
    np.testing.assert_array_equal(out["q_tokens"], q_tokens)
    np.testing.assert_array_equal(out["res"].doc_ids.numpy(),
                                  np.asarray(jres.doc_ids))
    np.testing.assert_array_equal(out["res"].n_candidates.numpy(),
                                  np.asarray(jres.n_candidates))
    np.testing.assert_array_equal(out["exact"].numpy(), np.asarray(jexact))

    example.main(["--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("HI² top-10 contains the exact top-1 item for ")
    assert line.endswith(f"/{n} candidates")
