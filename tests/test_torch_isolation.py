"""The port stands alone: tpusr_torch and chip_smoke.py import no JAX, no
flax and nothing of the JAX package, at import time or lazily; nor Orbax's
zstandard or tensorstore (the port reads and writes Orbax checkpoints with
its own codecs); nor OpenCV,
PIL, matplotlib, pandas or scikit-learn (the port draws its figures with
its own writer, ``tpusr_torch/viz``), nor h5py, TensorFlow or Keras (the
port reads and writes Keras files with its own codec), nor PyAV or
imageio (the port reads video with its own demuxers and decoders), which
the card's machine does not have."""

import ast
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "tpusr",
             "zstandard", "tensorstore"}  # the port's own zstd and OCDBT
IMAGE_LIBS = {"cv2", "PIL", "matplotlib", "sklearn",   # absent on the card's
              "pandas", "mpl_toolkits", "av", "imageio"}  # machine
HDF5_LIBS = {"h5py", "tensorflow", "keras"}            # absent there too


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            roots.add(node.args[0].value.split(".")[0])
    return roots


def test_every_port_module_imports_without_jax():
    code = (
        "import importlib, pkgutil, sys, tpusr_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(tpusr_torch.__path__, "
        "'tpusr_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN | IMAGE_LIBS | HDF5_LIBS!r})\n"
        "assert not bad, bad\n"
        "print(' '.join(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    # every module was imported, the classic-SR subpackages included
    assert len(mods) >= 30, sorted(mods)
    assert {"tpusr_torch.classic.algorithms", "tpusr_torch.classic.harness",
            "tpusr_torch.metrics.image", "tpusr_torch.metrics.stats",
            "tpusr_torch.core.nlm", "tpusr_torch.core.resize",
            "tpusr_torch.models.block1", "tpusr_torch.models.edsr_quant",
            "tpusr_torch.entry", "tpusr_torch.config",
            "tpusr_torch.models.esrgan", "tpusr_torch.models.api",
            "tpusr_torch.pipeline.inference", "tpusr_torch.pipeline.png",
            "tpusr_torch.pipeline.http_serving",
            "tpusr_torch.cli.__main__", "tpusr_torch.data.loading",
            "tpusr_torch.data.degrade", "tpusr_torch.utils",
            "tpusr_torch.pipeline.jpeg", "tpusr_torch.pipeline.imdecode",
            "tpusr_torch.pipeline.bmp", "tpusr_torch.pipeline.tiff",
            "tpusr_torch.metrics.lpips",
            "tpusr_torch.tools.lpips_weights", "tpusr_torch.data.eda",
            "tpusr_torch.data._cv_ops", "tpusr_torch.tools.imagenet_weights",
            "tpusr_torch.models.edsr_fast", "tpusr_torch.core.winograd",
            "tpusr_torch.train.hdf5", "tpusr_torch.train.keras_import",
            "tpusr_torch.train.keras_export", "tpusr_torch.train.zstd",
            "tpusr_torch.train.ocdbt", "tpusr_torch.train.zarr",
            "tpusr_torch.train.orbax", "tpusr_torch.viz",
            "tpusr_torch.viz.figure", "tpusr_torch.viz.render",
            "tpusr_torch.viz.colormaps", "tpusr_torch.viz.font",
            "tpusr_torch.viz.classic_viz", "tpusr_torch.viz.dl_viz"} <= mods


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*(REPO / "tpusr_torch").rglob("*.py"),
                                       REPO / "chip_smoke.py"]))
def test_source_names_no_jax_import(path):
    roots = _imported_roots(REPO / path)
    assert not roots & FORBIDDEN, (path, sorted(roots & FORBIDDEN))


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*(REPO / "tpusr_torch").rglob("*.py"),
                                       REPO / "chip_smoke.py"]))
def test_source_names_no_image_library(path):
    roots = _imported_roots(REPO / path)
    assert not roots & IMAGE_LIBS, (path, sorted(roots & IMAGE_LIBS))


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*(REPO / "tpusr_torch").rglob("*.py"),
                                       REPO / "chip_smoke.py"]))
def test_source_names_no_hdf5_or_keras_library(path):
    roots = _imported_roots(REPO / path)
    assert not roots & HDF5_LIBS, (path, sorted(roots & HDF5_LIBS))


CTYPES_LOADERS = {"CDLL", "PyDLL", "LibraryLoader", "LoadLibrary",
                  "find_library", "dlopen"}
CTYPES_NAMESPACES = {"cdll", "pydll"}     # ctypes.cdll.libfoo loads libfoo


def _ctypes_loads(path: pathlib.Path) -> list[str]:
    """Where a source loads a shared library through ``ctypes``: a call of
    a loader (``ctypes.CDLL(...)``, ``cdll.LoadLibrary(...)``,
    ``find_library(...)``), an attribute of ``cdll``/``pydll``, or such a
    name imported from ``ctypes``."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Call):
            name = getattr(node.func, "attr", getattr(node.func, "id", ""))
            if name in CTYPES_LOADERS:
                found.append(f"{ast.unparse(node.func)}()")
        elif isinstance(node, ast.Attribute) and \
                getattr(node.value, "attr", getattr(node.value, "id", "")) \
                in CTYPES_NAMESPACES:
            found.append(ast.unparse(node))
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.module.split(".")[0] == "ctypes":
            found += [f"from {node.module} import {a.name}"
                      for a in node.names if a.name in CTYPES_LOADERS
                      | CTYPES_NAMESPACES or node.module == "ctypes.util"]
    return found


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*(REPO / "tpusr_torch").rglob("*.py"),
                                       REPO / "chip_smoke.py"]))
def test_no_module_loads_a_shared_library_but_the_built_kernels(path):
    found = _ctypes_loads(REPO / path)
    if path == "tpusr_torch/core/_build.py":
        # its one load: a library it built from csrc/ into _build/, by path
        assert found == ["ctypes.CDLL()"], found
        src = (REPO / path).read_text()
        assert "ctypes.CDLL(str(_lib_path(name)))" in src
        assert 'BUILD_DIR = _PKG / "_build"' in src
        assert 'return BUILD_DIR / f"lib{name}-' in src
    else:
        assert not found, (path, found)


def test_viz_exports_the_jax_viz_names():
    """``tpusr_torch.viz`` exports the 16 names of ``tpusr/viz/__init__.py``
    and ``classification_report_dict``, and imports no image, plotting or
    dataframe library (run alone, in a fresh process)."""
    names = sorted(n for n in _imported_names(REPO / "tpusr" / "viz" / "__init__.py"))
    assert len(names) == 16
    code = (
        "import sys, tpusr_torch.viz as v\n"
        f"missing = [n for n in {names + ['classification_report_dict']!r} "
        "if not callable(getattr(v, n, None))]\n"
        "assert not missing, missing\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN | IMAGE_LIBS | HDF5_LIBS!r})\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imported_names(path: pathlib.Path) -> set[str]:
    return {a.asname or a.name for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.ImportFrom) and node.level == 0
            and node.module.startswith("tpusr.viz") for a in node.names}
