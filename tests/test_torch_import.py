"""The port stands alone: importing `voxelslam_tpu_torch` (every module of
it) pulls in neither JAX nor the JAX package, no file of the port, of
chip_smoke.py or of the scenario module it imports names them, and the pipeline refuses to start without a
device when CUDA is absent."""

import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "voxelslam_tpu_torch"


def _modules():
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in PORT.rglob("*.py"))


def test_import_pulls_in_no_jax():
    code = textwrap.dedent(f"""
        import importlib, sys
        for m in {_modules()!r}:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules if m == "jax"
                     or m.startswith("jax.") or m == "voxelslam_tpu"
                     or m.startswith("voxelslam_tpu."))
        assert not bad, bad
        print(len([m for m in sys.modules
                   if m.startswith("voxelslam_tpu_torch")]))
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= len(_modules())


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in list(PORT.rglob("*.py"))
    + list(PORT.rglob("*.cu")) + list(PORT.rglob("*.cpp"))
    + [ROOT / "chip_smoke.py", ROOT / "tools" / "elevator_trace.py"]))
def test_sources_name_no_jax(path):
    text = (ROOT / path).read_text()
    for word in ("import jax", "from jax", "voxelslam_tpu."):
        assert word not in text, (path, word)


def test_precision_flags_set_on_import():
    import voxelslam_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_pipeline_without_device_needs_cuda():
    from voxelslam_tpu_torch.config import small_test_config
    from voxelslam_tpu_torch.pipeline import SlamPipeline
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        SlamPipeline(small_test_config())
    pipe = SlamPipeline(small_test_config(), device="cpu")
    assert pipe.device.type == "cpu" and pipe.x.R.device.type == "cpu"
