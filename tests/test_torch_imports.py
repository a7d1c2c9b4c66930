"""The port stands alone: no file of dmayolo_tpu_torch/ and not
chip_smoke.py imports jax or the JAX package, nor PIL or torchvision, nor
orbax, tensorstore, zstandard or ml_dtypes (the Orbax checkpoints go
through the port's own OCDBT and zarr code and the system's libzstd), nor
tensorflow, tflite_runtime, ai_edge_litert or flatbuffers (TFLite models
are read, written and run by the port's own FlatBuffers codec and
program), nor
OpenCV but in the one lazy accessor `data/imageio.py::_cv2` (video and
webp go through cv2's decoder there, as the JAX package's; every other
image is read and written by the port's own host library), by an AST
walk."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "dmayolo_tpu_torch"
FILES = sorted((ROOT / "dmayolo_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "dmayolo_tpu", "cv2", "PIL", "torchvision",
             "orbax", "tensorstore", "zstandard", "ml_dtypes",
             "tensorflow", "tflite_runtime", "ai_edge_litert", "flatbuffers")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def forbidden_imports(source: str, rel: str):
    """The imports of FORBIDDEN modules in `source` (the file `rel` below
    the package), but those LAZY allows."""
    tree = ast.parse(source, rel)
    names = list(_imported(tree))
    for mod, fn in _imports_with_scope(tree):
        if LAZY.get((mod or "").split(".")[0]) == (rel, fn):
            names.remove(mod)  # this one import, in its function
    return [n for n in names if n.split(".")[0] in FORBIDDEN]


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_import(path):
    rel = path.relative_to(PKG).as_posix() if PKG in path.parents else path.name
    bad = forbidden_imports(path.read_text(), rel)
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("rel,source", [
    ("data/imageio.py", "import cv2\n"),  # at the top, not in _cv2
    ("data/imageio.py", "def _webp_decode():\n    import cv2\n"),
    ("data/video.py", "def _cv2():\n    import cv2\n"),  # another file's _cv2
    ("cli/detect.py", "def f():\n    from cv2 import VideoCapture\n"),
    ("chip_smoke.py", "def probe():\n    import cv2\n"),
    ("data/imageio.py", "def _cv2():\n    import jax\n"),
    ("data/imageio.py", "import cv2\ndef _cv2():\n    import cv2\n"),  # and at the top
])
def test_other_cv2_imports_fail(rel, source):
    """The walk still refuses cv2 anywhere but `imageio._cv2`, and jax
    even there."""
    assert forbidden_imports(source, rel)
    assert not forbidden_imports("def _cv2():\n    import cv2\n", "data/imageio.py")


def test_port_has_its_own_configs():
    """Byte-identical copies of all 69 model yamls of the JAX package
    (tests/test_torch_zoo_models.py names them) and of the hyps."""
    models = sorted(p.stem for p in (ROOT / "dmayolo_tpu_torch" / "configs" / "models").glob(
        "*.yaml"))
    assert len(models) == 69
    assert models == sorted(p.stem for p in (ROOT / "dmayolo_tpu" / "configs" / "models").glob(
        "*.yaml"))
    assert {"ablation-ca-scconv-sppfcspc", "yolov5n", "yolov5s", "C3CASPD2", "CASPD_ODRTA",
            "yolov5l-ca-sppfcspc-bifpn-scconv", "yolov5l-xs-tph",
            "ca-sppfcspc-bifpn-scconv-adapt-hornet", "ghostnet", "yolov3-tiny"} <= set(models)
    for kind, names in (("models", models), ("hyp", ("scratch", "visdrone"))):
        for name in names:
            ours = (ROOT / "dmayolo_tpu_torch" / "configs" / kind / f"{name}.yaml").read_bytes()
            assert ours == (ROOT / "dmayolo_tpu" / "configs" / kind / f"{name}.yaml").read_bytes()


# the only places the port may import these, and only inside the function
LAZY = {"matplotlib": ("utils/plots.py", "_plt"),
        "pandas": ("hub.py", "pandas"),
        "cv2": ("data/imageio.py", "_cv2")}


def _imports_with_scope(tree):
    """(module, enclosing function name or None) for every import."""
    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            name = child.name if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
            if isinstance(child, ast.Import):
                yield from ((a.name, fn) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                yield child.module, fn
            yield from walk(child, name)
    yield from walk(tree, None)


@pytest.mark.parametrize("source", [
    "import orbax.checkpoint as ocp\n",
    "def restore():\n    import tensorstore as ts\n",
    "from zstandard import ZstdDecompressor\n",
    "def bf16():\n    import ml_dtypes\n",
])
def test_checkpoint_libraries_fail(source):
    """The walk refuses the libraries under the JAX package's Orbax
    checkpoints, at a module's top and inside a function."""
    assert forbidden_imports(source, "utils/orbax_ckpt.py")


@pytest.mark.parametrize("source", [
    "import tensorflow as tf\n",
    "def run():\n    from tflite_runtime.interpreter import Interpreter\n",
    "from ai_edge_litert.interpreter import Interpreter\n",
    "def read():\n    import flatbuffers\n",
])
def test_tflite_libraries_fail(source):
    """The walk refuses TensorFlow and the TFLite runtimes and the
    flatbuffers package, at a module's top and inside a function."""
    assert forbidden_imports(source, "cli/tflite_run.py")


def test_matplotlib_and_pandas_only_lazily():
    """matplotlib (absent on the card's machine), pandas and cv2 are
    imported only inside `utils/plots.py::_plt` (which every plot calls),
    `hub.py::Detections.pandas` and `data/imageio.py::_cv2` (webp and
    video), as the JAX package does, never at a module's top."""
    seen = set()
    for path in FILES:
        rel = path.relative_to(PKG).as_posix() if PKG in path.parents else path.name
        for mod, fn in _imports_with_scope(ast.parse(path.read_text(), str(path))):
            top = (mod or "").split(".")[0]
            if top in LAZY:
                assert (rel, fn) == LAZY[top], f"{rel} imports {mod} in {fn or 'the module'}"
                seen.add(top)
    assert seen == set(LAZY)
