"""PyTorch port, ``utils/chiplock.py``: the cases of the JAX package's
chip-lock tests (tests/test_utils.py) against the port's copy, and the
variables shared with the JAX module, so that the two packages' tools
exclude each other on one lock file."""

import fcntl
import os
import subprocess
import sys
import time

from pumiumtally_tpu.utils import chiplock as jax_chiplock
from pumiumtally_tpu_torch.utils import chiplock


def _busy_lock(tmp_path, monkeypatch):
    """Point the module at a fresh lock file, clear the in-process /
    inherited short-circuits, and hold the lock on an independent file
    descriptor (flock treats separate descriptors as separate owners,
    so this models 'another process holds the window')."""
    lockfile = str(tmp_path / "chip.lock")
    monkeypatch.setattr(chiplock, "LOCK_PATH", lockfile)
    monkeypatch.setattr(chiplock, "_held_in_process", False)
    monkeypatch.delenv(chiplock._HELD_ENV, raising=False)
    fd = os.open(lockfile, os.O_CREAT | os.O_RDWR, 0o666)
    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    return fd


def test_chip_lock_nonblocking_busy(tmp_path, monkeypatch):
    """blocking=False against a held lock yields False immediately and
    leaves no holder state behind."""
    fd = _busy_lock(tmp_path, monkeypatch)
    try:
        t0 = time.monotonic()
        with chiplock.chip_lock(blocking=False) as held:
            assert held is False
            # A busy miss must NOT masquerade as a held window.
            assert chiplock._held_in_process is False
            assert chiplock._HELD_ENV not in os.environ
        assert time.monotonic() - t0 < 0.5  # no 1 s retry sleep
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def test_chip_lock_timeout_expires_busy(tmp_path, monkeypatch):
    """A timeout that expires while the lock stays busy yields False
    after at least one retry sleep, without acquiring."""
    fd = _busy_lock(tmp_path, monkeypatch)
    try:
        t0 = time.monotonic()
        with chiplock.chip_lock(timeout_s=0.01) as held:
            assert held is False
        # One failed attempt, one 1 s sleep, one deadline check.
        assert time.monotonic() - t0 >= 0.9
        assert chiplock._held_in_process is False
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def test_chip_lock_acquires_after_release(tmp_path, monkeypatch):
    """After the contender releases: acquisition succeeds, exports the
    child-inheritance env var, nests reentrantly, and cleans up."""
    fd = _busy_lock(tmp_path, monkeypatch)
    fcntl.flock(fd, fcntl.LOCK_UN)
    os.close(fd)
    with chiplock.chip_lock(blocking=False) as held:
        assert held is True
        assert os.environ[chiplock._HELD_ENV] == "1"
        assert chiplock._held_in_process is True
        # Nested acquire in the same process: inherited, no deadlock.
        with chiplock.chip_lock(blocking=False) as inner:
            assert inner is True
    assert chiplock._HELD_ENV not in os.environ
    assert chiplock._held_in_process is False


def test_chip_lock_parent_env_inherited(tmp_path, monkeypatch):
    """A child of a lock holder sees the env var and skips acquisition
    entirely: proven by pointing LOCK_PATH somewhere unopenable."""
    monkeypatch.setattr(chiplock, "_held_in_process", False)
    monkeypatch.setattr(
        chiplock, "LOCK_PATH", str(tmp_path / "no_dir" / "x.lock")
    )
    monkeypatch.setenv(chiplock._HELD_ENV, "1")
    with chiplock.chip_lock(blocking=False) as held:
        assert held is True  # os.open would have raised if attempted


# Each module loaded from its file: the JAX module is stdlib-only, and
# its package's __init__ would import jax.
_HOLD = """
import importlib.util, sys, time
spec = importlib.util.spec_from_file_location("chiplock", {path!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
with mod.chip_lock(blocking=False) as held:
    print("HELD" if held else "BUSY", flush=True)
    time.sleep(float(sys.argv[1]))
"""


_PATHS = """
import importlib.util
for name, path in (("port", {port!r}), ("jax", {jax!r})):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    print(mod.LOCK_PATH)
"""


def _lock_paths(**env) -> list:
    """(the port's, the JAX module's) LOCK_PATH in a fresh process whose
    environment is this one's with ``env`` set and no lock file named."""
    base = {k: v for k, v in os.environ.items()
            if k not in ("PUMIUMTALLY_CHIP_LOCK", "TMPDIR")}
    r = subprocess.run(
        [sys.executable, "-c", _PATHS.format(port=chiplock.__file__,
                                             jax=jax_chiplock.__file__)],
        capture_output=True, text=True, env={**base, **env}, timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split()


def test_chip_lock_excludes_the_jax_tools(tmp_path):
    """The same variables as the JAX module, and its lock file where
    ``TMPDIR`` is /tmp or the variable names one: a process holding the
    JAX package's lock keeps the port's busy, and the reverse. By
    default the port's file lies in the temporary directory, so runs
    with temporary directories of their own do not wait on each
    other."""
    assert chiplock._HELD_ENV == jax_chiplock._HELD_ENV
    assert _lock_paths(TMPDIR="/tmp") == ["/tmp/pumiumtally_chip.lock"] * 2
    assert _lock_paths(TMPDIR=str(tmp_path)) == [
        str(tmp_path / "pumiumtally_chip.lock"),
        "/tmp/pumiumtally_chip.lock"]
    named = str(tmp_path / "shared.lock")
    assert _lock_paths(TMPDIR=str(tmp_path),
                       PUMIUMTALLY_CHIP_LOCK=named) == [named] * 2
    env = {k: v for k, v in os.environ.items()
           if k != chiplock._HELD_ENV}
    env["PUMIUMTALLY_CHIP_LOCK"] = str(tmp_path / "chip.lock")
    for holder, other in ((jax_chiplock.__file__, chiplock.__file__),
                          (chiplock.__file__, jax_chiplock.__file__)):
        p = subprocess.Popen(
            [sys.executable, "-c", _HOLD.format(path=holder), "30"],
            stdout=subprocess.PIPE, text=True, env=env)
        try:
            assert p.stdout.readline().strip() == "HELD"
            r = subprocess.run([sys.executable, "-c",
                                _HOLD.format(path=other), "0"],
                               capture_output=True, text=True, env=env,
                               timeout=60)
            assert r.stdout.strip() == "BUSY", r.stderr[-2000:]
        finally:
            p.kill()
            p.wait()
