"""Run-time setup: optional PyYAML, the compile-cache helper, and the
helpers of chip_smoke.py that run without a card."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from dicp_tpu import config
from dicp_tpu.utils import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_icp_without_pyyaml():
    """import dicp_tpu and dicp_tpu.ICP() need no PyYAML; only parsing a
    user's YAML file does."""
    code = ("import sys; sys.modules['yaml'] = None\n"
            "import dicp_tpu\n"
            "icp = dicp_tpu.ICP()\n"
            "assert icp.config == dicp_tpu.config.DEFAULT_CONFIG\n"
            "assert icp._base_cfg.tanh_steepness == 5.0\n"
            "try:\n"
            "    dicp_tpu.config.load_yaml_config(dicp_tpu.config.DEFAULT_CONFIG_PATH)\n"
            "except ImportError:\n"
            "    print('yaml-needed')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "yaml-needed"


def test_default_config_equals_yaml_file():
    yaml = pytest.importorskip("yaml")
    with open(config.DEFAULT_CONFIG_PATH) as f:
        assert yaml.safe_load(f) == config.DEFAULT_CONFIG
    # the no-path load is a copy: callers may mutate it freely
    c = config.load_yaml_config()
    c["dICP"]["parameters"]["tanh_steepness"] = -1.0
    assert config.DEFAULT_CONFIG["dICP"]["parameters"]["tanh_steepness"] == 5.0


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(device.CACHE_ENV, str(tmp_path))
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # JAX reads the env


def test_compile_cache_defaults_to_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(device.CACHE_ENV, raising=False)
    try:
        path = device.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.fixture
def smoke():
    sys.path.insert(0, REPO)
    import chip_smoke
    return chip_smoke


def test_smoke_last_line_format(smoke):
    line = smoke.final_line({"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                             "count": 1})
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(smoke.final_line(
        {"platform": "gpu", "kind": "k", "count": np.int64(4)}))["device"][
        "count"] == 4


def test_smoke_four_option(smoke):
    assert smoke.parse_args([]).four is False
    assert smoke.parse_args(["--four"]).four is True
    with pytest.raises(SystemExit):
        smoke.parse_args(["--bogus"])


def test_smoke_reference_comparison(smoke):
    y = np.array([[0.0, 0, 0], [2.0, 0, 0], [0, 5.0, 0]])
    x = np.array([[1.0, 0, 0], [0, 4.0, 0]])       # query 0 ties points 0/1
    ref_idx, ref_d2 = np.array([0, 2]), np.array([1.0, 1.0])
    assert smoke.check_nn([0, 2], [1.0, 1.0], ref_idx, ref_d2, x, y)["ok"]
    tie = smoke.check_nn([1, 2], [1.0, 1.0], ref_idx, ref_d2, x, y)
    assert tie["ok"] and tie["idx_mismatch"] == 1
    wrong = smoke.check_nn([0, 0], [1.0, 1.0], ref_idx, ref_d2, x, y)
    assert not wrong["ok"] and not wrong["mismatches_are_ties"]
    assert not smoke.check_nn([0, 2], [1.0, 1.1], ref_idx, ref_d2, x, y)["ok"]


def test_smoke_refuses_without_gpu(smoke, capsys):
    """No accelerator: non-zero exit and no result line."""
    assert smoke.main([]) == 2
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "no GPU" in out.err
