"""Mid-run checkpoints of the port (`utils/checkpoint.py`,
`SlamSystem.save_checkpoint`/`load_checkpoint`): a system restored into a
fresh object continues bitwise equal to the uninterrupted one (both runs
are the port on the CPU), whatever was in flight at the save; loading
refuses mismatched enable flags, another format version and a checkpoint
written by the JAX package (without importing it).

Config and packets are tests/test_checkpoint.py's."""

import dataclasses
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from voxelslam_tpu import config as jconfig
from voxelslam_tpu.pipeline.system import SlamSystem as JSystem
from voxelslam_tpu_torch import config as tconfig
from voxelslam_tpu_torch.pipeline import SlamSystem
from voxelslam_tpu_torch.utils import checkpoint as ckpt

from test_checkpoint import _packets

torch.set_num_threads(1)

N_PRE, N_POST = 16, 4


def _cfg(mod=tconfig, **lba):
    """tests/test_checkpoint.py's config; GBA windows of 2 keyframes so a
    window is dispatched early in the run."""
    return mod.SlamConfig(
        map=mod.MapConfig(capacities=(1 << 11, 1 << 12, 1 << 12),
                          unique_max=(1024, 1024, 2048)),
        odom=mod.OdometryConfig(point_max=1024, imu_max=64),
        lba=mod.LocalBAConfig(factor_max=256, **lba),
        gba=mod.GBAConfig(win_size=2, stride=1))


@pytest.fixture(scope="module")
def packets():
    return _packets(48)


def _step(sysm, pkt):
    out = sysm.process_scan(*pkt)
    return out, sysm.odom.x.p.numpy().copy(), sysm.odom.x.R.numpy().copy()


def _resume_case(tmp_path, packets, make, saved_at, what):
    """Run `make()` until `saved_at(system, out, k)` holds (at scan
    N_PRE or later), save, continue N_POST scans; a fresh `make()` loads
    the file and continues on the same scans. Returns the saved system's
    state check `what(system)` and asserts bitwise equality."""
    sys1 = make()
    k = 0
    while True:
        out = sys1.process_scan(*packets[k])
        k += 1
        if k >= N_PRE and saved_at(sys1, out, k):
            break
        assert k + N_POST < len(packets), "save point not reached"
    state = what(sys1)
    path = str(tmp_path / "live.ckpt")
    sys1.save_checkpoint(path)
    ref = [_step(sys1, p) for p in packets[k:k + N_POST]]
    sys2 = make()
    sys2.load_checkpoint(path)
    got = [_step(sys2, p) for p in packets[k:k + N_POST]]
    for (o1, p1, R1), (o2, p2, R2) in zip(ref, got):
        assert o1 == o2
        assert np.array_equal(p1, p2) and np.array_equal(R1, R2)
    for a, b in zip(sys1.scan_poses, sys2.scan_poses):
        assert np.array_equal(a.p, b.p) and np.array_equal(a.R, b.R)
    assert len(sys2.scan_poses) == len(sys1.scan_poses)
    assert sys2.corrections == sys1.corrections
    return sys1, sys2, state


def test_resume_loop_on(tmp_path, packets):
    sys1, sys2, _ = _resume_case(
        tmp_path, packets, lambda: SlamSystem(_cfg(), device="cpu"),
        lambda s, out, k: True, lambda s: None)
    assert sys1.odom.init_done and sys2.odom.scan_count == \
        sys1.odom.scan_count
    assert [db._nat is not None for db in sys2.loop.dbs] == [True] * len(
        sys2.loop.dbs)
    assert sys2.loop.dbs[0].frames.keys() == sys1.loop.dbs[0].frames.keys()


def test_resume_gba_window_in_flight(tmp_path, packets):
    """Saved right after a keyframe dispatched a GBA window: the window is
    saved in flight and harvested after the restore as it would have
    been."""
    sys1, sys2, state = _resume_case(
        tmp_path, packets,
        lambda: SlamSystem(_cfg(), enable_gba=True, device="cpu"),
        lambda s, out, k: s.gba._inflight_step is not None,
        lambda s: len(s.gba.window_log))
    assert state >= 1
    assert len(sys2.gba.window_log) == len(sys1.gba.window_log)
    assert len(sys2.gba.edges1) == len(sys1.gba.edges1)
    for a, b in zip(sys1.gba.submaps, sys2.gba.submaps):
        assert np.array_equal(a.cloud, b.cloud)


def _batched_cfg():
    cfg = _cfg()
    return dataclasses.replace(cfg, odom=dataclasses.replace(
        cfg.odom, batch_scans=4))


def test_resume_scan_queue_partly_filled(tmp_path, packets):
    """batch_scans = 4 (loop off): saved with 1-3 scans queued for the next
    K-step call (the last call emitted its own rows: nothing pending)."""
    cfg = _batched_cfg()
    sys1, _, queued = _resume_case(
        tmp_path, packets,
        lambda: SlamSystem(cfg, enable_loop=False, device="cpu"),
        lambda s, out, k: 0 < len(s.odom._scan_queue) < 4,
        lambda s: len(s.odom._scan_queue))
    assert 0 < queued < 4 and sys1.odom._pending is None


def test_resume_deferred_batch_of_an_earlier_version(tmp_path, packets):
    """A checkpoint whose K-step call deferred its rows (`_pending`, as
    the emission before it read a replay's rows one call later) is
    restored: the next call hands them out, and the run goes on bitwise
    as if they had left with their own call."""
    cfg = _batched_cfg()
    make = lambda: SlamSystem(cfg, enable_loop=False, device="cpu")
    ref, old = make(), make()
    k = 0
    while True:
        assert k + N_POST < len(packets), "save point not reached"
        due = (k >= N_PRE and old.odom.init_done
               and len(old.odom._scan_queue) == 3)
        if due:      # this call dispatches: defer its rows by hand
            od = old.odom

            def defer(ring, fill, t_ends, *a, at_dispatch=False):
                od._pending = (ring.clone(), fill, t_ends, None, None, None)
                return {"phase": "odom", "pending": True}
            od._emit = defer
        ref.process_scan(*packets[k])
        old.process_scan(*packets[k])
        k += 1
        if due:
            del od._emit
            break
    held = old.odom._pending[1]
    assert held == 4 and len(old.scan_poses) == len(ref.scan_poses) - held
    path = str(tmp_path / "old.ckpt")
    old.save_checkpoint(path)
    new = make()
    new.load_checkpoint(path)
    assert new.odom._pending is not None
    out = new.process_scan(*packets[k])
    ref.process_scan(*packets[k])
    assert out["phase"] == "odom" and "pending" not in out
    assert new.odom._pending is None
    assert len(new.scan_poses) == len(ref.scan_poses)
    got = [_step(new, p) for p in packets[k + 1:k + 1 + N_POST]]
    want = [_step(ref, p) for p in packets[k + 1:k + 1 + N_POST]]
    for (o1, p1, R1), (o2, p2, R2) in zip(want, got):
        assert o1 == o2
        assert np.array_equal(p1, p2) and np.array_equal(R1, R2)
    assert len(new.scan_poses) == len(ref.scan_poses)
    for a, b in zip(ref.scan_poses, new.scan_poses):
        assert a.t == b.t and a.session == b.session
        assert np.array_equal(a.p, b.p) and np.array_equal(a.R, b.R)
    assert new.odom.jour == ref.odom.jour


def test_resume_mgsize2_refill_scan(tmp_path, packets):
    """lba.mgsize = 2: saved on a window-refill scan (`_mega_accum`)."""
    _, sys2, _ = _resume_case(
        tmp_path, packets, lambda: SlamSystem(_cfg(mgsize=2), device="cpu"),
        lambda s, out, k: bool(out.get("accum")), lambda s: None)
    assert sys2.odom.win_count < sys2.cfg.lba.win_size


def test_load_refuses_mismatched_flags_and_version(tmp_path):
    sysm = SlamSystem(_cfg(), enable_gba=True, device="cpu")
    path = str(tmp_path / "a.ckpt")
    sysm.save_checkpoint(path)
    for kw, flag in ((dict(enable_loop=False), "enable_loop"),
                     (dict(enable_gba=False), "enable_gba")):
        with pytest.raises(ValueError, match=flag):
            SlamSystem(_cfg(), device="cpu", **kw).load_checkpoint(path)
    with open(path, "rb") as f:
        blob = ckpt._Unpickler(f, torch.device("cpu")).load()
    blob["version"] = ckpt.FORMAT_VERSION + 1
    with open(path, "wb") as f:
        ckpt._Pickler(f).dump(blob)
    with pytest.raises(ValueError, match="version"):
        SlamSystem(_cfg(), enable_gba=True,
                   device="cpu").load_checkpoint(path)


def test_load_refuses_unlisted_classes(tmp_path):
    """The unpickler admits no callable outside its lists."""
    path = str(tmp_path / "evil.ckpt")
    with open(path, "wb") as f:
        pickle.dump({"version": ckpt.FORMAT_VERSION, "x": print}, f)
    with pytest.raises(pickle.UnpicklingError, match="builtins:print"):
        SlamSystem(_cfg(), device="cpu").load_checkpoint(path)


def test_tensors_saved_as_host_copies(tmp_path):
    """The file holds numpy copies, one per tensor object; load puts them
    on the restoring system's device."""
    sysm = SlamSystem(_cfg(), device="cpu")
    path = str(tmp_path / "a.ckpt")
    sysm.save_checkpoint(path)
    with open(path, "rb") as f:
        raw = f.read()
    assert b"torch._utils" not in raw and b"_rebuild" not in raw
    re = SlamSystem(_cfg(), device="cpu")
    re.load_checkpoint(path)
    assert re.odom.x.R.device.type == "cpu"
    assert torch.equal(re.odom.levels[0].keys, sysm.odom.levels[0].keys)


def test_load_refuses_jax_checkpoint(tmp_path):
    """A checkpoint of the JAX package's save_system is refused with a
    clear message, in a process that never imports JAX or its package."""
    path = str(tmp_path / "jax.ckpt")
    JSystem(_cfg(jconfig)).save_checkpoint(path)
    code = textwrap.dedent(f"""
        import sys
        from voxelslam_tpu_torch.config import SlamConfig
        from voxelslam_tpu_torch.pipeline import SlamSystem
        try:
            SlamSystem(SlamConfig(), device="cpu").load_checkpoint({path!r})
        except Exception as e:
            print(type(e).__name__, e)
        else:
            raise SystemExit("loaded a JAX checkpoint")
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "voxelslam_tpu"))
        assert not bad, bad
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("UnpicklingError")
    assert "written by the JAX package" in res.stdout
