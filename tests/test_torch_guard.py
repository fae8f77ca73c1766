"""Guards of the port's boundaries: ``repro_torch`` and
``chip_smoke.py`` import neither jax nor the reference package; entry
points refuse to fall back to the CPU when the card is missing; the CPU
path of the kernel wrappers is lazy about the CUDA build."""
import ast
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import exec as qexec
from repro_torch.core import hybrid_index as hi
from repro_torch.core import segments
from repro_torch.kernels import _build
from repro_torch.kernels.assign_topk import ops as at_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve
from repro_torch.launch import train
from repro_torch.models import transformer as tfm

torch.set_num_threads(2)

_ROOT = pathlib.Path(__file__).resolve().parent.parent
_PORT = _ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(r"^(jax|jaxlib)\b|\brepro\b(?!_torch)")


def _imported_modules(path: pathlib.Path) -> list[str]:
    """Every module named by an import statement (or a literal
    ``importlib.import_module`` / ``__import__`` argument) in ``path``."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            names.append(node.args[0].value)
    return names


def test_port_sources_import_neither_jax_nor_the_reference():
    files = sorted(_PORT.rglob("*.py")) + [_ROOT / "chip_smoke.py"]
    assert len(files) > 20
    walked = {f.relative_to(_PORT).as_posix() for f in files[:-1]}
    assert {"data/synthetic.py", "kernels/sq8_dot/ops.py",
            "kernels/sq8_dot/ref.py", "core/kmeans.py",
            "core/codecs/sq8.py", "core/codecs/refine.py",
            "models/layers.py", "models/attention.py",
            "models/transformer.py", "core/distill.py", "launch/train.py",
            "kernels/flash_attention/ops.py",
            "kernels/flash_attention/ref.py",
            "kernels/assign_topk/ops.py", "core/segments.py",
            "benchmarks/streaming_updates.py", "launch/runtime.py",
            "benchmarks/serving_load.py", "rowwise.py",
            "core/exec/frontier.py", "launch/tune.py",
            "checkpoint/manager.py", "benchmarks/autotune.py",
            "optim/adam.py", "optim/grad.py", "optim/schedule.py",
            "distributed/fault.py", "tree.py",
            "benchmarks/sup_distill.py", "distributed/collectives.py",
            "core/sharded_index.py", "launch/mesh.py",
            "benchmarks/sharded_search.py", "models/recsys.py",
            "data/recsys.py", "configs/registry.py", "configs/shapes.py",
            "configs/sasrec.py", "examples/recsys_retrieval.py",
            "models/gnn.py", "data/graph.py",
            "configs/gatedgcn.py", "data/tokenizer.py", "work.py",
            "launch/cells.py", "launch/dryrun.py", "launch/roofline.py",
            "launch/report.py", "launch/hillclimb.py", "benchmarks/run.py",
            "benchmarks/check_regression.py"} <= walked
    offenders = [(f.relative_to(_ROOT).as_posix(), m) for f in files
                 for m in _imported_modules(f) if _FORBIDDEN.search(m)]
    assert not offenders, offenders
    # the scan itself sees what it must refuse
    assert _FORBIDDEN.search("repro.core") and _FORBIDDEN.search("jax.numpy")
    assert not _FORBIDDEN.search("repro_torch.core")


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'repro'))\n"
        "assert len(mods) > 20, mods\n"
        "assert {'repro_torch.data.synthetic',"
        " 'repro_torch.kernels.sq8_dot.ops', 'repro_torch.launch.train',"
        " 'repro_torch.models.transformer',"
        " 'repro_torch.kernels.flash_attention.ops',"
        " 'repro_torch.core.segments',"
        " 'repro_torch.benchmarks.streaming_updates',"
        " 'repro_torch.launch.runtime', 'repro_torch.rowwise',"
        " 'repro_torch.benchmarks.serving_load',"
        " 'repro_torch.core.exec.frontier', 'repro_torch.launch.tune',"
        " 'repro_torch.checkpoint.manager',"
        " 'repro_torch.benchmarks.autotune', 'repro_torch.optim.adam',"
        " 'repro_torch.optim.grad', 'repro_torch.optim.schedule',"
        " 'repro_torch.distributed.fault', 'repro_torch.tree',"
        " 'repro_torch.benchmarks.sup_distill',"
        " 'repro_torch.distributed.collectives',"
        " 'repro_torch.core.sharded_index', 'repro_torch.launch.mesh',"
        " 'repro_torch.benchmarks.sharded_search',"
        " 'repro_torch.models.recsys', 'repro_torch.data.recsys',"
        " 'repro_torch.configs.registry', 'repro_torch.configs.dlrm_rm2',"
        " 'repro_torch.examples.recsys_retrieval',"
        " 'repro_torch.models.gnn', 'repro_torch.data.graph',"
        " 'repro_torch.data.tokenizer', 'repro_torch.work',"
        " 'repro_torch.launch.cells', 'repro_torch.launch.dryrun',"
        " 'repro_torch.launch.roofline', 'repro_torch.launch.report',"
        " 'repro_torch.launch.hillclimb',"
        " 'repro_torch.configs.gatedgcn', 'repro_torch.configs.llama3_8b',"
        " 'repro_torch.configs.internlm2_1_8b',"
        " 'repro_torch.configs.stablelm_3b',"
        " 'repro_torch.models.attention', 'repro_torch.models.moe',"
        " 'repro_torch.configs.mixtral_8x22b',"
        " 'repro_torch.configs.olmoe_1b_7b',"
        " 'repro_torch.benchmarks.run',"
        " 'repro_torch.benchmarks.check_regression'} <= set(mods), mods\n"
        "from repro_torch.configs import registry\n"
        "assert len(registry.all_archs()) == 11\n"
        "assert not bad, bad\n")
    env = {"PYTHONPATH": str(_ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _tiny_index(device="cpu"):
    rng = np.random.default_rng(0)
    n, h, l, v = 40, 8, 4, 16
    leaves = {
        ".cluster_sel.embeddings": rng.normal(size=(l, h)).astype(np.float32),
        ".term_sel.avg_scores": rng.random(v).astype(np.float32),
        ".cluster_lists.entries": np.arange(n, dtype=np.int32).reshape(l, -1),
        ".cluster_lists.lengths": np.full(l, n // l, np.int32),
        ".term_lists.entries": np.full((v, 2), -1, np.int32),
        ".term_lists.lengths": np.zeros(v, np.int32),
        ".codec_params.codewords": rng.normal(size=(2, 16, 4)).astype(
            np.float32),
        ".doc_planes['codes']": rng.integers(0, 16, (n, 2)).astype(np.uint8),
        ".doc_assign": np.repeat(np.arange(l, dtype=np.int32), n // l),
    }
    return leaves, ckpt.index_from_numpy(leaves, "pq", device=device)


def test_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    leaves, index = _tiny_index()
    qe = np.zeros((2, 8), np.float32)
    qt = np.full((2, 3), -1, np.int32)
    with pytest.raises(RuntimeError, match="cuda"):
        hi.search(index, qe, qt, kc=2, k2=2, top_r=5)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.Server(index, serve.ServeConfig(max_batch=4))
    with pytest.raises(RuntimeError, match="cuda"):
        ckpt.index_from_numpy(leaves, "pq")
    from repro_torch.launch import tune
    oracle = np.zeros((2, 1), np.int64)
    with pytest.raises(RuntimeError, match="cuda"):
        tune.tune_index(index, qe, qt, oracle, top_r=5, grid=((1, 1),))
    # the same calls run when the caller asks for the CPU
    res = hi.search(index, qe, qt, kc=2, k2=2, top_r=5, device="cpu")
    assert res.doc_ids.shape == (2, 5)
    tuned, points = tune.tune_index(index, qe, qt, oracle, top_r=5,
                                    grid=((1, 1), (2, 2)), device="cpu")
    assert len(points) == 2 and tuned.rungs[-1] == (tuned.kc, tuned.k2)
    # the dry run's entry points: the card by default (its kernels' fake
    # paths), the plain versions when asked for the CPU
    from repro_torch.launch import dryrun, hillclimb
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.run_cell("sasrec", "serve_p99", False)
    with pytest.raises(RuntimeError, match="cuda"):
        hillclimb.measure("sasrec", "serve_p99", {})
    rec = dryrun.run_cell("sasrec", "serve_p99", False, device="cpu")
    assert rec["status"] == "ok" and rec["fits"] is None
    assert hillclimb.measure("sasrec", "serve_p99", {},
                             device="cpu")["hbm_gb"] > 0


def test_bench_driver_without_device_exits_nonzero_when_cuda_is_absent(
        monkeypatch, capsys):
    """The driver resolves ``--device`` (default cuda) before it prints a
    row, so without a card it fails instead of benchmarking the CPU;
    ``--list`` needs no card."""
    from repro_torch.benchmarks import run as bench_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench_run.main(["--only", "kernel_bench"])
    with pytest.raises(RuntimeError, match="cuda"):
        bench_run.main([])
    assert capsys.readouterr().out == ""
    bench_run.main(["--list"])
    assert len(capsys.readouterr().out.split()) == 14
    env = {"PYTHONPATH": str(_ROOT / "src"), "PATH": "/usr/bin:/bin",
           "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.run", "--only",
         "kernel_bench"], env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "torch.cuda.is_available() is False" in proc.stderr


def test_mutable_entry_points_without_device_raise_when_cuda_is_absent(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(40, 8)).astype(np.float32)
    tok = rng.integers(0, 16, (40, 3)).astype(np.int32)
    kw = dict(n_clusters=4, k1_terms=1, delta_capacity=4)
    with pytest.raises(RuntimeError, match="cuda"):
        segments.MutableHybridIndex.create(0, emb, tok, 16, **kw)
    with pytest.raises(RuntimeError, match="cuda"):
        ckpt.load_mutable("no-such-dir", seed=0)
    mut = segments.MutableHybridIndex.create(0, emb, tok, 16, device="cpu",
                                             **kw)
    cfg = serve.ServeConfig(kc=2, k2=1, top_r=5, max_batch=4, mutable=True)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.make_mutable_server(mut, cfg)
    # the same calls run when the caller asks for the CPU
    server = serve.make_mutable_server(mut, cfg, device="cpu")
    server.add(emb[:2], tok[:2])
    assert server.query(emb[:3], tok[:3]).doc_ids.shape == (3, 5)


def test_unported_layouts_and_codecs_raise(tmp_path):
    leaves, index = _tiny_index()
    # the sharded and 2-D mesh layouts are ported (positions on the CPU
    # here), the sharded mutable one too
    for field, kind in ((dict(n_shards=2), "ShardedServer"),
                        (dict(data_parallel=2), "MeshServer")):
        server = serve.make_server(
            index, serve.ServeConfig(max_batch=4, **field), device="cpu")
        assert type(server).__name__ == kind
    rng = np.random.default_rng(2)
    mut = segments.MutableHybridIndex.create(
        0, rng.normal(size=(40, 8)).astype(np.float32),
        rng.integers(0, 16, (40, 3)).astype(np.int32), 16, n_clusters=4,
        k1_terms=1, delta_capacity=4, device="cpu")
    for field in (dict(n_shards=2), dict(n_shards=2, data_parallel=2)):
        server = serve.make_mutable_server(mut, serve.ServeConfig(
            kc=2, k2=1, top_r=5, max_batch=4, mutable=True, **field),
            device="cpu")
        assert type(server).__name__ == "ShardedMutableServer"
        assert server.query(np.zeros((2, 8), np.float32),
                            np.zeros((2, 3), np.int32)).doc_ids.shape[0] == 2
        server.mesh.close()
    # the mutable layout is ported: make_server refuses it as the
    # reference does, pointing at make_mutable_server
    with pytest.raises(ValueError, match="make_mutable_server"):
        serve.make_server(index, serve.ServeConfig(mutable=True),
                          device="cpu")
    # every reference codec is ported: an unknown spec names them all
    with pytest.raises(ValueError, match="flat, opq, pq, refine, sq8"):
        ckpt.index_from_numpy(leaves, "sq9", device="cpu")
    # hybrid fusion is ported: sparse=True builds the impact plane, and
    # an index without one serves a fusion request dense-only, exactly
    rng = np.random.default_rng(1)
    sparse = hi.build(0, rng.normal(size=(40, 8)).astype(np.float32),
                      rng.integers(0, 16, (40, 3)).astype(np.int32), 16,
                      n_clusters=4, k1_terms=1, sparse=True, device="cpu")
    assert (sparse.sparse_weights.shape
            == sparse.term_lists.entries.shape)
    qe, qt = np.zeros((1, 8), np.float32), np.zeros((1, 2), np.int32)
    dense = hi.search(index, qe, qt, kc=1, k2=1, top_r=3, device="cpu")
    fused = hi.search(index, qe, qt, kc=1, k2=1, top_r=3, device="cpu",
                      fusion=qexec.FusionSpec(weight=0.5))
    assert index.sparse_weights is None
    assert torch.equal(dense.doc_ids, fused.doc_ids)
    assert torch.equal(dense.scores, fused.scores)


def test_load_index_refuses_tuned_widths(tmp_path):
    """Tuned widths are ported: a full record is attached to the loaded
    index; a malformed one (fields missing) is refused, not served with
    other widths."""
    import json
    leaves, _ = _tiny_index()
    paths = list(leaves)
    np.savez(tmp_path / "arrays.npz",
             **{f"leaf_{i}": leaves[p] for i, p in enumerate(paths)})
    manifest = {"leaves": [{"path": p, "index": i}
                           for i, p in enumerate(paths)],
                "extra": {"codec": "pq"}}
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    loaded = ckpt.load_index(str(tmp_path), device="cpu")
    assert loaded.codec == "pq" and loaded.tuned is None
    record = {"kc": 3, "k2": 4, "refine_mult": None, "recall_target": 0.9,
              "recall": 0.92, "cost": 40, "rungs": [[1, 2], [3, 4]],
              "margin_cuts": [0.25]}
    manifest["extra"]["tuned"] = record
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    tuned = ckpt.load_index(str(tmp_path), device="cpu").tuned
    assert (tuned.kc, tuned.k2, tuned.rungs, tuned.margin_cuts) == (
        3, 4, ((1, 2), (3, 4)), (0.25,))
    manifest["extra"]["tuned"] = {"kc": 3, "k2": 4}
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(KeyError):
        ckpt.load_index(str(tmp_path), device="cpu")


def test_kernel_build_is_lazy_and_outside_the_package():
    """Nothing is built at import, libraries go under build/ (which git
    ignores), and every kernel source is registered for the build."""
    assert _build.BUILD_DIR == _ROOT / "build" / "kernels"
    assert not _build._LIBS or torch.cuda.is_available()
    srcs = sorted(p.relative_to(_PORT).as_posix()
                  for p in _PORT.rglob("*.cu"))
    assert srcs == sorted(p.relative_to(_PORT).as_posix()
                          for p in _build.SOURCES.values())
    assert "build/" in (_ROOT / ".gitignore").read_text().split()


def _tiny_sup(device="cpu"):
    """A 1-layer encoder and its DistillParams, all zeros but the norms."""
    cfg = tfm.TransformerConfig(n_layers=1, d_model=8, n_heads=2,
                                n_kv_heads=2, d_ff=16, vocab_size=12,
                                causal=False, compute_dtype=torch.float32)
    z = torch.zeros
    enc = {"embed": {"table": z(12, 8)}, "final_norm": {"scale": z(8) + 1},
           "unembed": {"w": z(8, 12)},
           "layers": {"attn_norm": {"scale": z(1, 8) + 1},
                      "mlp_norm": {"scale": z(1, 8) + 1},
                      "attn": {k: {"w": z(1, 8, 8)}
                               for k in ("wq", "wk", "wv", "wo")},
                      "mlp": {"w_gate": {"w": z(1, 8, 16)},
                              "w_up": {"w": z(1, 8, 16)},
                              "w_down": {"w": z(1, 16, 8)}}}}
    from repro_torch.core import distill, term_selector as ts
    params = distill.DistillParams(
        z(4, 8), ts.TermMLP(z(8, 8), z(8), z(8, 1), z(1)), enc)
    return cfg, params


def test_sup_entry_points_without_device_raise_when_cuda_is_absent(
        monkeypatch):
    """HI²_sup indexing defaults to the card and never falls back to the
    CPU; the same calls run when the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, params = _tiny_sup()

    class Corpus:
        doc_emb = np.random.default_rng(0).normal(size=(40, 8)).astype(
            np.float32)
        doc_tokens = np.random.default_rng(1).integers(0, 12, (40, 6))
        vocab_size = 12

    assign = np.arange(40, dtype=np.int32) % 4
    with pytest.raises(RuntimeError, match="cuda"):
        train.SupSelectors(params, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        train.build_sup_index(Corpus, params, cfg, assign, k1_terms=2,
                              codec="flat")
    with pytest.raises(RuntimeError, match="cuda"):
        ckpt.distill_params_from_numpy({}, cfg)
    idx = train.build_sup_index(Corpus, params, cfg, assign, k1_terms=2,
                                codec="flat", device="cpu")
    assert idx.device == torch.device("cpu") and idx.n_docs == 40


def test_training_entry_points_without_device_raise_when_cuda_is_absent(
        monkeypatch):
    """``fit`` and ``train_hi2_sup`` default to the card and never fall
    back to the CPU; the same calls run when the caller asks for it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = {"w": torch.zeros(3)}

    def loss_fn(p, batch):
        loss = torch.sum((p["w"] - batch) ** 2)
        return loss, {"loss": loss}

    def batches(i):
        return np.full(3, float(i), np.float32)

    with pytest.raises(RuntimeError, match="cuda"):
        train.fit(loss_fn, params, batches, 2, log_every=0)
    from repro_torch.data import synthetic
    corpus = synthetic.generate(seed=0, n_docs=64, n_queries=8, hidden=8,
                                vocab_size=64, n_topics=4,
                                make_model_b=False)
    cfg = train.SupTrainConfig(n_clusters=4, encoder_layers=1,
                               encoder_dim=8, encoder_heads=2, n_steps=2,
                               batch_queries=4, n_negatives=2,
                               kmeans_iters=2)
    with pytest.raises(RuntimeError, match="cuda"):
        train.train_hi2_sup(corpus, cfg, log_every=0)
    p, losses = train.fit(loss_fn, params, batches, 2, log_every=0,
                          device="cpu")
    assert p["w"].device.type == "cpu" and len(losses) == 2
    tp, _, assign, losses = train.train_hi2_sup(corpus, cfg, log_every=0,
                                                device="cpu")
    assert tp.cluster_embeddings.device.type == "cpu" and len(losses) == 2


def test_new_kernel_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card is refused, not
    computed some other way."""
    x = torch.zeros(3, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        at_ops.assign_argmax(x, torch.zeros(4, 8, device="meta"))
    q = torch.zeros(1, 2, 4, 16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa_ops.flash_attention(q, q, q)


def test_recsys_entry_points_without_device_raise_when_cuda_is_absent(
        monkeypatch, capsys):
    """The recsys data generators, the parameter carry-over and the
    example ask for the card by default; the same calls run on the CPU
    when asked."""
    from repro_torch.data import recsys as rdata
    from repro_torch.examples import recsys_retrieval
    from repro_torch.models import recsys
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gens = {rdata.dlrm_batch: dict(n_rows=50),
            rdata.sasrec_batch: dict(n_items=50),
            rdata.dien_batch: dict(n_items=50),
            rdata.mind_batch: dict(n_items=50)}
    for gen, kw in gens.items():
        with pytest.raises(RuntimeError, match="cuda"):
            gen(0, 2, **kw)
        batch = gen(0, 2, **kw, device="cpu")
        assert all(t.device.type == "cpu" for t in batch)
    cfg = recsys.MINDConfig(n_items=10, embed_dim=4)
    leaves = {"['item_embed']['table']": np.zeros((10, 4), np.float32),
              "['bilinear']['w']": np.zeros((4, 4), np.float32)}
    with pytest.raises(RuntimeError, match="cuda"):
        ckpt.recsys_params_from_numpy("mind", leaves, cfg)
    params = ckpt.recsys_params_from_numpy("mind", leaves, cfg,
                                           device="cpu")
    assert params["bilinear"]["w"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        recsys_retrieval.main([])
    monkeypatch.setattr(recsys_retrieval, "N_ITEMS", 2_000)
    monkeypatch.setattr(recsys_retrieval, "N_CLUSTERS", 16)
    recsys_retrieval.main(["--device", "cpu"])
    assert "/2000 candidates" in capsys.readouterr().out


def test_graph_entry_points_without_device_raise_when_cuda_is_absent(
        monkeypatch):
    """The graph data generators, the sampler and the GatedGCN parameter
    carry-over ask for the card by default and run on the CPU when
    asked; ``partition_by_dst`` keeps its input's device."""
    from repro_torch.data import graph
    from repro_torch.models import gnn
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        graph.random_graph(0, 20, 40, 3, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        graph.molecule_batch(0, 2, 5, 6, 3, 2)
    g = graph.random_graph(0, 20, 40, 3, 2, device="cpu")
    sampler = graph.NeighborSampler(20, g.edge_src, g.edge_dst)
    with pytest.raises(RuntimeError, match="cuda"):
        sampler.sample(0, np.arange(4), (2,), g.node_feat, g.labels)
    sub = sampler.sample(0, np.arange(4), (2,), g.node_feat, g.labels,
                         device="cpu")
    assert sub.node_feat.device.type == "cpu"
    assert graph.partition_by_dst(g, 2).node_feat.device.type == "cpu"
    cfg = gnn.GatedGCNConfig(n_layers=1, d_hidden=2, d_feat=3, n_classes=2)
    leaves = {p: np.zeros(s, np.float32)
              for p, s in ckpt._gnn_shapes(cfg).items()}
    with pytest.raises(RuntimeError, match="cuda"):
        ckpt.gnn_params_from_numpy(leaves, cfg)
    params = ckpt.gnn_params_from_numpy(leaves, cfg, device="cpu")
    assert gnn.forward(params, cfg, g).shape == (20, 2)


def test_lm_entry_points_without_device_raise_when_cuda_is_absent(
        monkeypatch):
    """The LM parameter carry-over and the decode caches ask for the card
    by default and run on the CPU when asked; the LM functions keep their
    inputs' device."""
    from repro_torch.models import transformer as tfm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tfm.TransformerConfig(n_layers=1, d_model=8, n_heads=2,
                                n_kv_heads=1, d_ff=16, vocab_size=10,
                                compute_dtype=torch.float32)
    leaves = {p: np.zeros(s, np.float32)
              for p, s in ckpt._lm_shapes(cfg).items()}
    with pytest.raises(RuntimeError, match="cuda"):
        ckpt.lm_params_from_numpy(leaves, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        tfm.init_decode_caches(cfg, 1, 4)
    params = ckpt.lm_params_from_numpy(leaves, cfg, device="cpu")
    caches = tfm.init_decode_caches(cfg, 1, 4, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    logits, caches = tfm.serve_step(params, cfg, caches, tokens[:, :1], 0)
    assert logits.device.type == caches.k.device.type == "cpu"
    assert tfm.prefill_step(params, cfg, tokens)[0].device.type == "cpu"


def test_moe_entry_points_without_device_raise_when_cuda_is_absent(
        monkeypatch):
    """An MoE config's parameter carry-over and decode caches ask for the
    card by default and run on the CPU when asked (the memory probe has
    no CPU path and refuses); the MoE layer, its mesh layout and the LM
    functions keep their inputs' device."""
    from repro_torch import tree
    from repro_torch.distributed import collectives
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tfm.TransformerConfig(n_layers=1, d_model=8, n_heads=2,
                                n_kv_heads=1, d_ff=16, vocab_size=10,
                                n_experts=4, compute_dtype=torch.float32)
    leaves = {p: np.full(s, 0.1, np.float32)
              for p, s in ckpt._lm_shapes(cfg).items()}
    assert "['layers']['moe']['w_gate']" in leaves
    with pytest.raises(RuntimeError, match="cuda"):
        ckpt.lm_params_from_numpy(leaves, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        tfm.init_decode_caches(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        collectives.Mesh([["cuda"] * 2], ("data", "model"))
    from repro_torch.benchmarks import lm_memory
    with pytest.raises(RuntimeError, match="cuda"):
        lm_memory.main(["--arch", "olmoe-1b-7b", "--train-batches", "1"])
    params = ckpt.lm_params_from_numpy(leaves, cfg, device="cpu")
    caches = tfm.init_decode_caches(cfg, 1, 4, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    logits, caches = tfm.serve_step(params, cfg, caches, tokens[:, :1], 0)
    assert logits.device.type == caches.k.device.type == "cpu"
    assert tfm.prefill_step(params, cfg, tokens)[0].device.type == "cpu"
    x = torch.ones((2, 3, 8))
    lp = tree.index(params["layers"]["moe"], 0)
    out, _ = moe.forward(lp, x, n_experts=4, top_k=2)
    mesh = collectives.Mesh([["cpu"] * 2], ("data", "model"))
    sharded, _ = moe.forward_shard_map(lp, x, n_experts=4, top_k=2,
                                       mesh=mesh)
    mesh.close()
    assert out.device.type == sharded.device.type == "cpu"


def test_flash_attention_head_dims_run_in_the_next_instance_up():
    """Any head dim 1 .. 128 has an instance in either dtype (d = 50,
    SASRec's, runs in the d = 64 one); f32 (the FMA kernel) has D 16,
    32, 64 and 128, bf16 (the tensor-core kernel) also D 80, so
    stablelm-3b's d 80 runs in its own; none above 128."""
    assert [fa_ops.instance_dim(d) for d in (1, 16, 17, 40, 50, 64, 65,
                                             128)] == [16, 16, 32, 64, 64,
                                                       64, 128, 128]
    assert [fa_ops.instance_dim(d, torch.float32) for d in (50, 80)] == [
        64, 128]
    assert [fa_ops.instance_dim(d, torch.bfloat16)
            for d in (1, 16, 17, 40, 50, 64, 65, 80, 81, 128)] == [
        16, 16, 32, 64, 64, 64, 80, 80, 128, 128]
    assert fa_ops.instance_name(80, torch.bfloat16) == "tensor-core D 80"
    assert fa_ops.instance_name(50, torch.float32) == "fp32 FMA D 64"
    for dtype in (torch.float32, torch.bfloat16):
        for d in (0, 129, 256):
            with pytest.raises(ValueError, match="head dim"):
                fa_ops.instance_dim(d, dtype)
