"""PyTorch port: the package, every submodule and ``chip_smoke`` import with
JAX and the JAX package made unimportable, and no source file of the port
imports either; the port's copies of the JAX package's host code (data
modules, tokenizer, predictions pickle) give what the JAX package gives."""

import os
import pathlib
import pickle
import pkgutil
import re
import subprocess
import sys

import numpy as np
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO_ROOT, "reprover_tpu_torch")


# The serving slice's modules: the streaming engines, quantized weights,
# the decoder-only family and the native BPE core.
NEW_MODULES = (
    "reprover_tpu_torch.ops.beam_reorder",
    "reprover_tpu_torch.ops.quant_matmul",
    "reprover_tpu_torch.models.quantize",
    "reprover_tpu_torch.models.causal_lm",
    "reprover_tpu_torch.models.hf_import_causal",
    "reprover_tpu_torch.generation.engine",
    "reprover_tpu_torch.generation.causal_engine",
    "reprover_tpu_torch.generation.causal_generator",
    "reprover_tpu_torch.generation.bpe_tokenizer",
    "reprover_tpu_torch.native.bpe",
    # Decoder-only fine-tuning and the kernel-timing scripts.
    "reprover_tpu_torch.generation.preprocess",
    "reprover_tpu_torch.generation.causal_datamodule",
    "reprover_tpu_torch.benchmarks",
    "reprover_tpu_torch.benchmarks.causal_finetune_step",
    "reprover_tpu_torch.benchmarks.flash_kernel_bisect",
    # Pretraining.
    "reprover_tpu_torch.training.pretrain",
    # The evaluation harnesses, the tooling and the service load driver.
    "reprover_tpu_torch.retrieval.evaluate",
    "reprover_tpu_torch.retrieval.bm25",
    "reprover_tpu_torch.prover.attribution",
    "reprover_tpu_torch.prover.api_generator",
    "reprover_tpu_torch.utils.misc",
    "reprover_tpu_torch.utils.profiling",
    "reprover_tpu_torch.benchmarks.service_load",
    "reprover_tpu_torch.scripts",
    "reprover_tpu_torch.scripts.data_stats",
    "reprover_tpu_torch.scripts.convert_checkpoint",
)


def _modules():
    import reprover_tpu_torch

    names = ["reprover_tpu_torch"]
    for info in pkgutil.walk_packages(reprover_tpu_torch.__path__, "reprover_tpu_torch."):
        names.append(info.name)
    return names


def test_port_imports_without_jax():
    names = _modules()
    assert "reprover_tpu_torch.prover.evaluate" in names
    assert "reprover_tpu_torch.ops.flash_attention" in names
    assert "reprover_tpu_torch.generation.main" in names
    for name in NEW_MODULES:
        assert name in names, name
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['reprover_tpu'] = None\n"
        f"for name in {names + ['chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and (\n"
        "       m == 'jax' or m.startswith('jax.') or m.split('.')[0] == 'reprover_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# An import statement, indented or not, that names jax or the JAX package
# (``reprover_tpu`` not followed by ``_torch``).
_FORBIDDEN_IMPORT = re.compile(r"^\s*(from|import)\s+(jax|reprover_tpu)(?![\w])")


def _port_sources():
    return [os.path.join(REPO_ROOT, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(PORT) for f in fs if f.endswith(".py")
    ]


def test_no_jax_import_in_port_sources():
    sources = _port_sources()
    for name in NEW_MODULES:  # the scan covers every new module, scripts/ included
        rel = name.split(".", 1)[1].replace(".", os.sep)
        assert (os.path.join(PORT, rel + ".py") in sources
                or os.path.join(PORT, rel, "__init__.py") in sources), name
    offenders = []
    for path in sources:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if _FORBIDDEN_IMPORT.match(line):
                    offenders.append(f"{path}:{i}: {line.strip()}")
    assert not offenders, offenders


def test_forbidden_import_pattern():
    """The scan's pattern catches indented imports of either package and
    passes the port's own."""
    for line in ("import jax", "    from jax import numpy", "from reprover_tpu.data import Pos",
                 "        import reprover_tpu", "from reprover_tpu import prover"):
        assert _FORBIDDEN_IMPORT.match(line), line
    for line in ("from reprover_tpu_torch.data import Pos", "import reprover_tpu_torch",
                 "    from reprover_tpu_torch import tokenizer", "x = 'import jax'"):
        assert not _FORBIDDEN_IMPORT.match(line), line


def test_port_api_fully_annotated(monkeypatch):
    """The port keeps the JAX package's typing gate (tests/test_annotations.py)."""
    import test_annotations

    monkeypatch.setattr(test_annotations, "PACKAGE", pathlib.Path(PORT))
    missing = test_annotations._missing_annotations()
    assert not missing, missing


def _batches_equal(ours, theirs):
    assert ours.keys() == theirs.keys()
    for key in ours:
        a, b = ours[key], theirs[key]
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            assert [repr(x) for x in a] == [repr(x) for x in b], key


def test_copied_data_modules_and_tokenizer_match_jax(toy_dataset_dir, toy_corpus_path):
    """On the toy dataset the port's retrieval and generator data modules give
    the JAX package's batches (shuffled and collated alike), and its
    tokenizer the same ids, masks and decodes."""
    from reprover_tpu.generation.datamodule import GeneratorDataModule as JGen
    from reprover_tpu.retrieval.datamodule import RetrievalDataModule as JRet
    from reprover_tpu.tokenizer import ByT5Tokenizer as JTok
    from reprover_tpu_torch.generation.datamodule import GeneratorDataModule as TGen
    from reprover_tpu_torch.retrieval.datamodule import RetrievalDataModule as TRet
    from reprover_tpu_torch.tokenizer import ByT5Tokenizer as TTok

    args = (toy_dataset_dir, toy_corpus_path, 2, 1, 2, 2, 256)
    ours, theirs = TRet(*args, seed=5), JRet(*args, seed=5)
    for stage in ("fit", "predict"):
        ours.setup(stage)
        theirs.setup(stage)
    for name in ("train_dataloader", "val_dataloader", "predict_dataloader"):
        for a, b in zip(getattr(ours, name)(), getattr(theirs, name)()):
            _batches_equal(a, b)

    gargs = (toy_dataset_dir, 2, 2, 256, 64, 0.5)
    ours, theirs = TGen(*gargs, seed=5), JGen(*gargs, seed=5)
    ours.setup(None)
    theirs.setup(None)
    for name in ("train_dataloader", "val_dataloader"):
        for a, b in zip(getattr(ours, name)(), getattr(theirs, name)()):
            _batches_equal(a, b)

    texts = ["theorem foo : 1 + 1 = 2 := by simp", "⊢ ∀ n : ℕ, n ≤ n", ""]
    a, b = TTok()(texts, max_length=40, bucket_multiple=16), JTok()(texts, max_length=40,
                                                                    bucket_multiple=16)
    np.testing.assert_array_equal(a.input_ids, b.input_ids)
    np.testing.assert_array_equal(a.attention_mask, b.attention_mask)
    assert [TTok().decode(r, skip_special_tokens=True) for r in a.input_ids] == [
        JTok().decode(r, skip_special_tokens=True) for r in b.input_ids]


def test_jax_predictions_pickle_loads_in_port(toy_corpus, tmp_path):
    """A ``predictions.pickle`` written by the JAX package's
    ``save_predictions`` loads through the port's ``load_preds`` into the
    port's classes, and one written by the port loads too."""
    from reprover_tpu.data import Context as JContext
    from reprover_tpu.data import Pos as JPos
    from reprover_tpu.retrieval.prediction import save_predictions as jsave
    from reprover_tpu_torch.data import Context, Pos, Premise
    from reprover_tpu_torch.generation.datamodule import load_preds
    from reprover_tpu_torch.retrieval.prediction import save_predictions

    premise = toy_corpus.all_premises[0]
    ctx = JContext("Toy/A.lean", "Toy.thm", JPos(3, 1), "⊢ True")
    record = {"context": ctx, "retrieved_premises": [premise], "scores": [0.5],
              "all_pos_premises": [premise], "file_path": ctx.path,
              "full_name": ctx.theorem_full_name, "start": JPos(3, 1), "tactic_idx": 0,
              "url": "u", "commit": "c"}
    path = str(tmp_path / "jax_predictions.pickle")
    jsave([record], path)
    preds = load_preds(path)
    got = preds["Toy/A.lean", "Toy.thm", "⊢ True"]
    assert type(got["context"]) is Context and type(got["start"]) is Pos
    assert type(got["retrieved_premises"][0]) is Premise
    assert got["retrieved_premises"][0].full_name == premise.full_name
    assert got["context"].theorem_pos == Pos(3, 1)

    path = str(tmp_path / "port_predictions.pickle")
    save_predictions([dict(got)], path)
    again = load_preds(path)["Toy/A.lean", "Toy.thm", "⊢ True"]
    assert again["context"] == got["context"]
    with open(path, "rb") as f:
        assert b"reprover_tpu_torch.data" in f.read()
    assert pickle.loads(pickle.dumps(again["start"])) == Pos(3, 1)


def _code_strings(path):
    """String constants of a Python source that are not docstrings."""
    import ast

    tree = ast.parse(open(path).read())
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


def test_no_path_into_jax_package():
    """No code of the new modules, of chip_smoke or of the native BPE loader
    names a file of the JAX package; the C++ core builds from the port's
    own copy into build/."""
    import importlib

    bpe = importlib.import_module("reprover_tpu_torch.native.bpe")
    assert os.path.dirname(bpe._SRC) == os.path.join(PORT, "native")
    assert os.path.exists(bpe._SRC)
    assert bpe._LIB.startswith(os.path.join(REPO_ROOT, "build") + os.sep)
    paths = [os.path.join(REPO_ROOT, "chip_smoke.py")] + [
        importlib.import_module(name).__file__ for name in NEW_MODULES]
    # A "file:line" reference (the kernels line's "replaces") names a TPU
    # kernel and opens nothing.
    offenders = [(path, text) for path in paths for text in _code_strings(path)
                 if re.search(r"(^|[/\\])reprover_tpu([/\\]|$)", text)
                 and not re.fullmatch(r"reprover_tpu/[\w/]+\.py:\d+", text)]
    assert not offenders, offenders
    with open(bpe._SRC) as f:
        assert "reprover_tpu/" not in f.read()
