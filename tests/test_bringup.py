"""Start-up rules: where the compile cache goes, and that the GPU smoke
run refuses to report success off the GPU."""
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_rule(env_set, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the program sets no cache directory
    (JAX reads the variable itself).  Unset: <checkout>/.jax_cache, an
    absolute path that .gitignore lists."""
    from peleanalysis_tpu import config
    calls = {}
    monkeypatch.setattr(config.jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = config.enable_compile_cache()
    if env_set:
        assert got is None
        assert "jax_compilation_cache_dir" not in calls
    else:
        want = os.path.join(REPO, ".jax_cache")
        assert got == want and os.path.isabs(got)
        assert calls["jax_compilation_cache_dir"] == want
        assert ".jax_cache/" in open(os.path.join(REPO, ".gitignore")).read()
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 1.0


@pytest.mark.parametrize("where", ["cpu_platform", "script_alone"])
def test_chip_smoke_fails_off_the_gpu(where, tmp_path):
    """Under JAX_PLATFORMS=cpu, and in a directory holding only the
    script, chip_smoke.py exits non-zero and prints no result line."""
    env = dict(os.environ)
    if where == "cpu_platform":
        env["JAX_PLATFORMS"] = "cpu"
        cwd, script = REPO, os.path.join(REPO, "chip_smoke.py")
    else:
        env.pop("JAX_PLATFORMS", None)
        env.pop("PYTHONPATH", None)
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd, script = str(tmp_path), str(tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(rec, dict) and rec.get("ok")), line
