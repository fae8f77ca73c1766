"""Port parity of the dry-run family: ``repro_torch.launch.cells``,
``dryrun``, ``roofline``, ``report``, ``hillclimb``, ``launch.mesh``'s
production meshes, ``Codec.abstract`` and the four kernels' fake paths,
against the live JAX package on the CPU.

* ``Codec.abstract`` at the hi2-synth widths (N 8,841,984, h 768, m 96,
  k 256): leaf shapes and dtypes equal the reference's
  ``ShapeDtypeStruct``s (under a ``FakeTensorMode``: nothing allocated).
* Eight cells at their full published configs and shapes: the port's
  fake argument leaves equal the reference's ``build_cell(...).args`` on
  a (1, 1) JAX mesh, shape and dtype in tree order, and so the global
  argument bytes (1,687.57 GB for mixtral-8x22b ``train_4k``, 563.46 GB
  for ``long_500k``).  No integer leaf differs in dtype.
* At ``make_reduced()`` and cut shapes, one cell of each kind runs on
  fake CPU tensors and on real ones drawn from a seed: the FLOPs counted
  are equal exactly, and so are the argument bytes.
* The live-bytes counter gives the hand-computed peak of a three-matmul
  chain.
* The four kernel wrappers on the dry run's path, on fake CUDA tensors
  with the kernel build patched to raise: the real launchers' output
  shapes and dtypes, their formulas' FLOPs, no launch.  The flash
  backward's fake path (fake CPU tensors: autograd on fake CUDA tensors
  needs a CUDA build) against a ``FlopCounterMode`` count of the real
  recompute, exactly, causal, windowed and ragged.
* MoE routes: ``_positions`` against the ``bincount`` it replaced.
* The CLI on sasrec ``serve_p99`` and the report of its record.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import registry as jregistry
from repro.core import codecs as jcodecs
from repro.distributed import compat as jcompat
from repro.launch import cells as jcells
from repro_torch import tree, work
from repro_torch.configs import registry, shapes
from repro_torch.core import codecs
from repro_torch.kernels import _build
from repro_torch.kernels.assign_topk import ops as at_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.pq_adc import ops as adc_ops
from repro_torch.kernels.sq8_dot import ops as sq8_ops
from repro_torch.launch import cells, dryrun, mesh as mesh_mod, report
from repro_torch.launch import roofline
from repro_torch.models import moe

torch.set_num_threads(2)

N_DOCS, HIDDEN, PQ_M, PQ_K = 8_841_984, 768, 96, 256


def _bytes(shape, dtype) -> int:
    return int(np.prod(shape)) * np.dtype(dtype).itemsize


def _np_dtype(t: torch.Tensor) -> np.dtype:
    return np.dtype(str(t.dtype).removeprefix("torch."))


# --------------------------------------------------------------------------
# Codec.abstract and the cells' arguments against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["flat", "pq", "opq", "sq8", "refine:pq",
                                  "refine:sq8:4"])
def test_codec_abstract_equals_the_reference(spec):
    want_p, want_planes = jcodecs.get(spec).abstract(N_DOCS, HIDDEN,
                                                     pq_m=PQ_M, pq_k=PQ_K)
    with FakeTensorMode():
        got_p, got_planes = codecs.get(spec).abstract(N_DOCS, HIDDEN,
                                                      pq_m=PQ_M, pq_k=PQ_K)
    want = jax.tree_util.tree_leaves((want_p, want_planes))
    got = tree.leaves(got_p) + tree.leaves(got_planes)
    assert [(tuple(g.shape), _np_dtype(g)) for g in got] == [
        (tuple(w.shape), np.dtype(w.dtype)) for w in want]
    if spec in ("pq", "opq"):
        assert got_planes["codes"].dtype == torch.uint8
    with pytest.raises(NotImplementedError):
        codecs.base.Codec().abstract(N_DOCS, HIDDEN)


CELLS = [("llama3-8b", "train_4k"), ("olmoe-1b-7b", "decode_32k"),
         ("mixtral-8x22b", "long_500k"), ("gatedgcn", "ogb_products"),
         ("sasrec", "train_batch"), ("dien", "retrieval_cand"),
         ("hi2-synth", "serve_msmarco_filtered"),
         ("hi2-synth", "serve_msmarco_refine_sq8")]
#: global argument bytes the reference's build_cell gives (GB, 1e9 B)
WANT_GB = {("mixtral-8x22b", "long_500k"): 563.46,
           ("hi2-synth", "serve_msmarco_refine_sq8"): 20.57,
           ("gatedgcn", "ogb_products"): 1.76}


@pytest.fixture(scope="module")
def jmesh():
    return jcompat.make_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("arch_id,shape_name", CELLS)
def test_cell_arguments_equal_the_reference(jmesh, arch_id, shape_name):
    want = jax.tree_util.tree_leaves(
        jcells.build_cell(arch_id, shape_name, jmesh).args)
    cell = cells.build_cell(arch_id, shape_name, device="cpu")
    got = cell.arg_leaves()
    assert all(work.is_fake(t) for t in got)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    # every leaf's dtype equal, integers included (int32 ids and
    # lengths, uint8 codes, uint32 filter words)
    assert [_np_dtype(g) for g in got] == [np.dtype(w.dtype) for w in want]
    got_bytes = sum(g.numel() * g.element_size() for g in got)
    assert got_bytes == sum(_bytes(w.shape, w.dtype) for w in want)
    if (arch_id, shape_name) in WANT_GB:
        assert round(got_bytes / 1e9, 2) == WANT_GB[arch_id, shape_name]
    assert cell.kind == jcells.build_cell(arch_id, shape_name,
                                          jmesh).kind


def test_mixtral_training_state_is_1688_gb():
    cell = cells.build_cell("mixtral-8x22b", "train_4k", device="cpu")
    got = sum(t.numel() * t.element_size() for t in cell.arg_leaves())
    assert round(got / 1e9, 2) == 1687.57
    assert cell.donate_argnums == (0, 1)


def test_production_meshes_have_the_reference_shapes():
    sp = mesh_mod.make_production_mesh(devices=["cpu"] * 256)
    mp = mesh_mod.make_production_mesh(multi_pod=True, devices=["cpu"] * 512)
    host = mesh_mod.make_host_mesh(devices=["cpu"] * 8)
    assert (sp.shape, sp.axis_names) == ({"data": 16, "model": 16},
                                         ("data", "model"))
    assert mp.shape == {"pod": 2, "data": 16, "model": 16}
    assert mp.axis_names == ("pod", "data", "model")
    assert host.shape == {"data": 2, "model": 4}
    for m in (sp, mp, host):
        m.close()
    with pytest.raises(RuntimeError, match="cards"):
        mesh_mod.make_production_mesh()
    with pytest.raises(ValueError, match="devices"):
        mesh_mod.make_host_mesh(1, 2, devices=["cpu"] * 3)


# --------------------------------------------------------------------------
# fake against real at make_reduced()
# --------------------------------------------------------------------------

def _hi2(name, **kw):
    base = registry.get("hi2-synth").shapes[name]
    return dataclasses.replace(
        base, n_docs=4096, hidden=32, n_clusters=16, vocab=64,
        cluster_capacity=64, term_capacity=32, pq_m=8, pq_k=16, kc=4, k2=4,
        top_r=10, query_batch=min(base.query_batch, 8), query_len=6, **kw)


def _reduced(arch_id, **kw):
    return dataclasses.replace(registry.get(arch_id).make_reduced(), **kw)


REDUCED = {
    "lm/train": ("olmoe-1b-7b", "train_4k",
                 shapes.LMShape("train_4k", "train", 24, 2),
                 _reduced("olmoe-1b-7b", remat=True)),
    "lm/prefill": ("llama3-8b", "prefill_32k",
                   shapes.LMShape("prefill_32k", "prefill", 32, 2),
                   _reduced("llama3-8b")),
    "lm/decode": ("mixtral-8x22b", "long_500k",
                  shapes.LMShape("long_500k", "decode", 40, 2),
                  _reduced("mixtral-8x22b")),
    "gnn/full": ("gatedgcn", "full_graph_sm",
                 shapes.GNNShape("full_graph_sm", "full", 300, 900, 24),
                 _reduced("gatedgcn")),
    "gnn/minibatch": ("gatedgcn", "minibatch_lg",
                      shapes.GNNShape("minibatch_lg", "minibatch", 600, 2000,
                                      24, batch_nodes=8, fanout=(3, 2)),
                      _reduced("gatedgcn")),
    "gnn/molecule": ("gatedgcn", "molecule",
                     shapes.GNNShape("molecule", "molecule", 10, 20, 24,
                                     batch_graphs=4),
                     _reduced("gatedgcn", graph_level=True)),
    "recsys/train": ("sasrec", "train_batch",
                     shapes.RecShape("train_batch", "train", 4),
                     registry.get("sasrec").make_reduced()),
    "recsys/serve": ("dien", "serve_p99",
                     shapes.RecShape("serve_p99", "serve", 4),
                     registry.get("dien").make_reduced()),
    "recsys/retrieval": ("dlrm-rm2", "retrieval_cand",
                         shapes.RecShape("retrieval_cand", "retrieval", 1,
                                         n_candidates=300),
                         registry.get("dlrm-rm2").make_reduced()),
    "hi2/serve": ("hi2-synth", "serve_msmarco_bucket8",
                  _hi2("serve_msmarco_bucket8"), None),
    "hi2/serve_filtered": ("hi2-synth", "serve_msmarco_filtered",
                           _hi2("serve_msmarco_filtered", n_namespaces=40),
                           None),
    "hi2/serve_sharded": ("hi2-synth", "serve_msmarco_refine_sq8",
                          _hi2("serve_msmarco_refine_sq8"), None),
    # hillclimb's two overrides: positions of a (2, 2) mesh under autograd
    "lm/train moe_impl=shard_map": (
        "olmoe-1b-7b", "train_4k", shapes.LMShape("train_4k", "train", 8, 4),
        _reduced("olmoe-1b-7b", moe_impl="shard_map")),
    "gnn/full impl=partitioned": (
        "gatedgcn", "full_graph_sm",
        shapes.GNNShape("full_graph_sm", "full", 1024, 2048, 24),
        _reduced("gatedgcn", impl="partitioned")),
}


@pytest.mark.parametrize("kind", sorted(REDUCED))
def test_fake_step_counts_the_flops_of_the_real_step(kind, monkeypatch):
    # blocks of 2^12 elements: the flash backward's fake path counts
    # several blocks it does not run
    monkeypatch.setattr(fa_ops, "BWD_PLANE", 2 ** 12)
    arch_id, shape_name, shape, cfg = REDUCED[kind]
    mesh = None
    if kind.startswith("hi2/serve_sharded") or " " in kind:
        mesh = mesh_mod.make_host_mesh(2, 2, devices=["cpu"] * 4)
    runs = {}
    for fake in (True, False):
        cell = cells.build_cell(arch_id, shape_name, mesh, device="cpu",
                                fake=fake, seed=3, config=cfg, shape=shape)
        assert cell.kind == kind.split(" ")[0]
        runs[fake] = cells.execute(cell)
        assert all(work.is_fake(t) == fake for t in cell.arg_leaves())
    fake, real = runs[True], runs[False]
    assert fake.count.flops == real.count.flops > 0
    assert fake.memory["argument"] == real.memory["argument"]
    for ex in (fake, real):
        assert ex.memory["peak"] >= ex.memory["argument"] > 0
        assert ex.memory["peak"] == (ex.memory["argument"]
                                     + ex.memory["output"]
                                     + ex.memory["temp"] - ex.memory["alias"])
    if kind.endswith("train") or kind.startswith("gnn"):
        # in place: the f32 params and both Adam moments are the outputs'
        # storages
        params = sum(t.numel() * t.element_size()
                     for t in tree.leaves(cell.args[0]))
        assert fake.memory["alias"] >= 3 * params
    if " " in kind:
        # the collectives between the positions, forward and backward
        assert fake.count.collectives == real.count.collectives
        assert {"broadcast", "reduce"} <= set(fake.count.collectives)
    if kind == "hi2/serve_sharded":
        # one position of the (2, 2) mesh: half the documents, half the
        # queries
        cell = cells.build_cell(arch_id, shape_name, mesh, device="cpu",
                                config=cfg, shape=shape)
        assert cell.args[0]["codec"]["codes"].shape == (1, 2048, 32)
        assert cell.args[2].shape == (4, 32)
    if mesh is not None:
        mesh.close()


def test_live_bytes_of_a_three_matmul_chain():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 64, generator=g)
    ws = [torch.randn(64, 256, generator=g), torch.randn(256, 256,
                                                         generator=g),
          torch.randn(256, 64, generator=g)]
    with roofline.counting() as count:
        args = count.hold((x, ws))
        h1 = x @ ws[0]
        h2 = h1 @ ws[1]
        del h1
        h3 = h2 @ ws[2]
    f32 = 4
    assert args == f32 * (8 * 64 + 64 * 256 + 256 * 256 + 256 * 64)
    # h1 and h2 live at once; h3 comes after h1 is freed
    assert count.peak_bytes == args + f32 * (8 * 256 + 8 * 256)
    assert count.live_bytes == args + f32 * (8 * 256 + 8 * 64)
    assert count.flops == 2 * 8 * (64 * 256 + 256 * 256 + 256 * 64)
    assert h3.shape == (8, 64)


# --------------------------------------------------------------------------
# the kernels' fake paths
# --------------------------------------------------------------------------

@pytest.fixture
def no_build(monkeypatch):
    def refuse(name):
        raise AssertionError(f"the fake path built {name}")
    monkeypatch.setattr(_build, "library", refuse)
    return [at_ops.launches, fa_ops.launches, adc_ops.launches,
            sq8_ops.launches]


def _launches():
    return [at_ops.launches, fa_ops.launches, adc_ops.launches,
            sq8_ops.launches]


def test_kernel_fake_paths_on_fake_cuda_tensors(no_build):
    b, c, n, h, m, k, l = 4, 300, 5000, 64, 8, 16, 700
    with FakeTensorMode(), work.counting() as tally:
        x = torch.empty(b, h, device="cuda")
        emb = torch.empty(l, h, device="cuda")
        s, i = at_ops.topk_scores(x, emb, 30)
        assert (s.shape, s.dtype, i.shape, i.dtype) == (
            (b, 30), torch.float32, (b, 30), torch.int32)
        assert s.device.type == "cuda" and work.is_fake(s)
        ids = torch.empty(b, c, dtype=torch.int32, device="cuda")
        live = torch.empty(b, c, dtype=torch.bool, device="cuda")
        lut = torch.empty(b, m, k, device="cuda")
        codes = torch.empty(n, m, dtype=torch.uint8, device="cuda")
        out = adc_ops.pq_adc_fused(lut, codes, ids, live)
        assert (out.shape, out.dtype) == ((b, c), torch.float32)
        plane = torch.empty(n, h, dtype=torch.uint8, device="cuda")
        out = sq8_ops.sq8_dot_fused(x, plane, ids, live)
        assert (out.shape, out.dtype) == ((b, c), torch.float32)
        q = torch.empty(2, 8, 40, 16, dtype=torch.bfloat16, device="cuda")
        kv = torch.empty(2, 2, 40, 16, dtype=torch.bfloat16, device="cuda")
        o, lse = fa_ops.flash_attention(q, kv, kv, True, 0)
        assert (o.shape, o.dtype, lse.shape, lse.dtype) == (
            (2, 8, 40, 16), torch.bfloat16, (2, 8, 40), torch.float32)
        # out is a (B, H, S, d) view of (B, S, H, d) memory, as launched
        assert o.stride() == (40 * 8 * 16, 16, 8 * 16, 1)
    assert _launches() == no_build
    assert {name: rec["calls"] for name, rec in tally.kernels.items()} == {
        "topk_scores": 1, "pq_adc_fused": 1, "sq8_dot_fused": 1,
        "flash_attention": 1}
    assert tally.kernels["topk_scores"]["flops"] == at_ops.work(
        b, l, h, 30)[0] == 2 * b * l * h
    assert tally.kernels["pq_adc_fused"]["flops"] == b * c * m
    assert tally.kernels["sq8_dot_fused"]["flops"] == 2 * b * c * h
    assert tally.kernels["flash_attention"]["flops"] == (
        4 * 2 * 8 * 16 * 40 * 41 // 2)
    assert tally.kernels["flash_attention"]["bytes"] == (
        2 * (2 * 2 * 8 * 40 * 16 + 2 * 2 * 2 * 40 * 16) + 4 * 2 * 8 * 40)


def test_kernel_wrappers_keep_their_cpu_and_meta_paths(no_build):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 2, 9, 8, generator=g)
    o, _ = fa_ops.flash_attention(q, q, q, True, 0)
    want, _ = fa_ops.ref.flash_attention(q, q, q, True, 0)
    torch.testing.assert_close(o, want, rtol=0, atol=0)
    x, emb = torch.randn(3, 8, generator=g), torch.randn(20, 8, generator=g)
    s, i = at_ops.topk_scores(x, emb, 4)
    assert torch.equal(i, at_ops.ref.topk_scores(x, emb, 4)[1])
    assert _launches() == no_build
    meta = torch.empty(1, 2, 9, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa_ops.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        at_ops.topk_scores(torch.empty(3, 8, device="meta"),
                           torch.empty(20, 8, device="meta"), 4)
    lut = torch.empty(1, 2, 4, device="meta")
    ids = torch.empty(1, 3, dtype=torch.int32, device="meta")
    live = torch.empty(1, 3, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        adc_ops.pq_adc_fused(lut, torch.empty(5, 2, dtype=torch.uint8,
                                              device="meta"), ids, live)
    with pytest.raises(ValueError, match="cpu or cuda"):
        sq8_ops.sq8_dot_fused(torch.empty(1, 4, device="meta"),
                              torch.empty(5, 4, dtype=torch.uint8,
                                          device="meta"), ids, live)


@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (2, 4, 2, 40, 16, True, 0),        # causal, GQA
    (1, 2, 2, 64, 8, True, 6),         # a window
    (2, 2, 1, 33, 16, False, 0),       # ragged S, not causal
    (1, 2, 2, 37, 8, False, 5),        # ragged, two-sided window
])
def test_flash_fake_backward_counts_the_real_recompute(
        monkeypatch, b, hq, hkv, s, d, causal, window):
    monkeypatch.setattr(fa_ops, "BWD_PLANE", 2 ** 10)
    assert len(fa_ops.bwd_blocks(torch.empty(b, hq, s, d),
                                 torch.empty(b, hkv, s, d), causal,
                                 window)) > 1
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, h, s, d, generator=g, requires_grad=True)
               for h in (hq, hkv, hkv))
    out, _ = fa_ops.flash_attention(q, k, v, causal, window)
    with FlopCounterMode(display=False) as real:
        out.backward(torch.randn(out.shape, generator=g))
    with FakeTensorMode():
        fq, fk, fv = (torch.empty(b, h, s, d, requires_grad=True)
                      for h in (hq, hkv, hkv))
        fout, _ = fa_ops.flash_attention(fq, fk, fv, causal, window)
        with roofline.counting() as count:
            fout.backward(torch.empty(fout.shape))
        grads = [t.grad for t in (fq, fk, fv)]
    assert [(x.shape, x.dtype) for x in grads] == [
        (x.shape, x.dtype) for x in (q.grad, k.grad, v.grad)]
    assert count.flops == real.get_total_flops()
    assert count.kernels["flash_attention.recompute"]["flops"] > 0


# --------------------------------------------------------------------------
# MoE routes, the CLI and the report
# --------------------------------------------------------------------------

def _positions_bincount(flat_e, n_experts):
    counts = torch.bincount(flat_e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    order = torch.sort(flat_e, stable=True).indices
    rank = torch.arange(flat_e.numel()) - starts[flat_e[order]]
    return torch.empty_like(rank).index_put_((order,), rank), counts


@pytest.mark.parametrize("seed", range(3))
def test_moe_positions_equal_the_bincount_they_replaced(seed):
    g = torch.Generator().manual_seed(seed)
    # experts 0, 5 and 7 of 8 get no assignment
    flat_e = torch.tensor([1, 2, 3, 4, 6])[
        torch.randint(0, 5, (257,), generator=g)]
    pos, counts = moe._positions(flat_e, 8)
    want_pos, want_counts = _positions_bincount(flat_e, 8)
    assert torch.equal(pos, want_pos) and torch.equal(counts, want_counts)
    assert counts.dtype == want_counts.dtype == torch.int64
    assert counts[[0, 5, 7]].sum() == 0


def test_dryrun_cli_and_report(tmp_path, monkeypatch):
    out = tmp_path / "dr"
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "sasrec", "--shape", "serve_p99",
                     "--device", "cpu", "--out", str(out)])
    assert done.value.code == 0
    assert sorted(os.listdir(tmp_path)) == ["dr"]
    assert sorted(os.listdir(out)) == ["sasrec_serve_p99_sp.json",
                                       "sasrec_serve_p99_sp.ops.json"]
    recs = report.load_records(str(out), "sp")
    assert len(recs) == 1
    rec = recs[0]
    assert (rec["cell"], rec["mesh"], rec["n_devices"], rec["kind"],
            rec["status"]) == ("sasrec/serve_p99", "16x16", 1,
                               "recsys/serve", "ok")
    mem = rec["memory"]
    assert mem["per_device_gb"] >= mem["argument_gb"] > 0.2
    assert abs(mem["per_device_gb"] - (mem["argument_gb"] + mem["output_gb"]
                                       + mem["temp_gb"] - mem["alias_gb"])
               ) < 1e-12
    assert rec["cost"]["flops"] > 0 and rec["fits"] is None
    assert rec["collectives"] == {"total_bytes": 0, "n_ops": 0, "by_op": {}}
    table = report.emit_tables(str(out))
    rows = [r for r in table.splitlines() if r.startswith("| sasrec")]
    assert len(rows) == 1 and "| ok |" in rows[0]
    assert "H100" in table and "16×16" in table
    skipped = dryrun.run_cell("llama3-8b", "long_500k", False, device="cpu")
    assert skipped["status"] == "skipped" and "brief" in skipped["reason"]
    assert jregistry.get("llama3-8b").skip_shapes == registry.get(
        "llama3-8b").skip_shapes


def test_mesh_positions_count_under_their_callers_modes():
    """Eight positions on four CPU cores, a short switch interval: every
    op of every position reaches the caller's counters once (a lost
    update or an op outside the modes would change the totals), the
    positions meet at a collective while they take turns, and a fake
    caller's factories and ``torch.tensor`` stay fake on the positions'
    threads."""
    import sys
    from repro_torch.distributed import collectives
    mesh = mesh_mod.make_host_mesh(2, 4, devices=["cpu"] * 8)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def body(coord):
            x = torch.ones(16, 32)
            for _ in range(25):
                x = x @ torch.ones(32, 32) / 32
            pos = mesh.position(coord)
            return pos.psum(x.sum(0), "model")

        with roofline.counting() as count:
            out = mesh.run(body)
        assert count.flops == 8 * 25 * 2 * 16 * 32 * 32
        assert count.collectives["all-reduce"] == {
            "calls": 8, "bytes": 8 * 3 * 32 * 4}
        assert all(torch.equal(o, torch.full((32,), 64.0))
                   for o in out.values())
        with FakeTensorMode():
            x = torch.empty(4, 4)
            out = mesh.run(lambda coord: (torch.zeros(4, 4), torch.tensor(
                3.0, device=x.device)))
        assert all(work.is_fake(t) for o in out.values() for t in o)
    finally:
        sys.setswitchinterval(interval)
        mesh.close()
    # every position gave its turn back
    assert collectives._TURN.acquire(timeout=1)
    collectives._TURN.release()
