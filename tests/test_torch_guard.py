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
from repro_torch.core import hybrid_index as hi
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
            "kernels/assign_topk/ops.py"} <= walked
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
        " 'repro_torch.kernels.flash_attention.ops'} <= set(mods), mods\n"
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
    # the same calls run when the caller asks for the CPU
    res = hi.search(index, qe, qt, kc=2, k2=2, top_r=5, device="cpu")
    assert res.doc_ids.shape == (2, 5)


def test_unported_layouts_and_codecs_raise(tmp_path):
    leaves, index = _tiny_index()
    for field in (dict(n_shards=2), dict(data_parallel=2),
                  dict(mutable=True)):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            serve.make_server(index, serve.ServeConfig(**field),
                              device="cpu")
    # every reference codec is ported: an unknown spec names them all
    with pytest.raises(ValueError, match="flat, opq, pq, refine, sq8"):
        ckpt.index_from_numpy(leaves, "sq9", device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        hi.build(0, np.zeros((40, 8), np.float32),
                 np.zeros((40, 3), np.int32), 16, n_clusters=4, k1_terms=1,
                 sparse=True, device="cpu")
    with pytest.raises(NotImplementedError, match="fusion"):
        hi.search(index, np.zeros((1, 8), np.float32),
                  np.zeros((1, 2), np.int32), kc=1, k2=1, top_r=3,
                  fusion=object(), device="cpu")


def test_load_index_refuses_tuned_widths(tmp_path):
    import json
    leaves, _ = _tiny_index()
    paths = list(leaves)
    np.savez(tmp_path / "arrays.npz",
             **{f"leaf_{i}": leaves[p] for i, p in enumerate(paths)})
    manifest = {"leaves": [{"path": p, "index": i}
                           for i, p in enumerate(paths)],
                "extra": {"codec": "pq"}}
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    assert ckpt.load_index(str(tmp_path), device="cpu").codec == "pq"
    manifest["extra"]["tuned"] = {"kc": 3, "k2": 4}
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(NotImplementedError, match="tuned widths"):
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


def test_new_kernel_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card is refused, not
    computed some other way."""
    x = torch.zeros(3, 8, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        at_ops.assign_argmax(x, torch.zeros(4, 8, device="meta"))
    q = torch.zeros(1, 2, 4, 16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa_ops.flash_attention(q, q, q)
