"""The port imports nothing of JAX, nothing of the JAX package and none of
the JAX side's data and checkpoint libraries (grain, orbax, safetensors,
peft) or ml_dtypes: it reads safetensors and PEFT adapters with its own
code, and carries bfloat16 and float8 KV blocks on the wire by name."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# grain, orbax, safetensors, peft, tornado (the JAX server's framework) and
# ml_dtypes (numpy's bfloat16 and float8, a JAX dependency) are not on the
# card either.
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "grain",
             "safetensors", "peft", "tornado", "ml_dtypes", "kubeflow_tpu")
#: Importable only lazily, inside this function (not on the card: a
#: bundled HF tokenizer is optional there).
LAZY = {"transformers": ("serve/tokenizer_util.py", "load_bundled_tokenizer"),
        "tokenizers": ("serve/tokenizer_util.py", "load_bundled_tokenizer")}


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(REPO, "kubeflow_tpu_torch")):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_module_imports_no_jax(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_server_import_loads_no_jax():
    code = ("import sys; import kubeflow_tpu_torch.serve.server; "
            "import kubeflow_tpu_torch.serve.openai_api; "
            "import kubeflow_tpu_torch.models.convert; "
            "import kubeflow_tpu_torch.train.trainer; "
            "import kubeflow_tpu_torch.train.checkpoint; "
            "import kubeflow_tpu_torch.train.lora; "
            "import kubeflow_tpu_torch.data.loader; "
            "import kubeflow_tpu_torch.models.hf_import; "
            "import kubeflow_tpu_torch.models.peft_import; "
            "import kubeflow_tpu_torch.serve.multilora; "
            "import kubeflow_tpu_torch.serve.storage; "
            "import kubeflow_tpu_torch.serve.kv_transfer; "
            "import kubeflow_tpu_torch.serve.batcher; "
            "import kubeflow_tpu_torch.serve.explain; "
            "import kubeflow_tpu_torch.models.bert; "
            "import kubeflow_tpu_torch.models.mlp; "
            "import kubeflow_tpu_torch.models.moe; "
            "import kubeflow_tpu_torch.utils.registry; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN + tuple(LAZY)!r}]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports_with_scope(path):
    """(root module, enclosing function name or None) of each import."""
    tree = ast.parse(open(path).read(), filename=path)

    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from walk(child, child.name)
                continue
            if isinstance(child, ast.Import):
                for alias in child.names:
                    yield alias.name.split(".")[0], fn
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module.split(".")[0], fn
            yield from walk(child, fn)

    return list(walk(tree, None))


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_hf_libraries_only_inside_the_tokenizer_loader(path):
    rel = os.path.relpath(path, os.path.join(REPO, "kubeflow_tpu_torch"))
    for root, fn in _imports_with_scope(path):
        if root in LAZY:
            assert (rel, fn) == LAZY[root], (
                f"{rel} imports {root} in {fn or 'module scope'}")

