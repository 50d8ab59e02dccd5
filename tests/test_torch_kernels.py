"""The moments kernel's wrapper (`voxelslam_tpu_torch.ops.moments`): its
dispatch and input checks on the CPU, and, on a card, the CUDA kernel
against its plain version. This file imports no JAX, so the card test
runs where JAX is absent:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from voxelslam_tpu_torch.ops import moments as mo

torch.set_num_threads(1)


def t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def n(x):
    return x.detach().cpu().numpy()


def test_accumulate_cpu_dispatch_is_plain_version():
    """On a CPU tensor `accumulate` is `accumulate_ref` and launches no
    kernel; out-of-range slots are dropped like XLA's mode="drop"."""
    caps = (64, 128)
    rng = np.random.default_rng(8)
    slots = np.stack([rng.integers(0, c, 90) for c in caps]).astype(np.int32)
    slots[0, :5] = 64                                   # out of range: dropped
    upd = rng.normal(size=(2, 90, 16)).astype(np.float32)
    before = mo.counter.launches
    a = mo.accumulate(t(slots, torch.int32), t(upd), caps)
    b = mo.accumulate_ref(t(slots, torch.int32), t(upd), caps)
    assert mo.counter.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    keep = slots[0] < 64
    np.testing.assert_allclose(n(a[0]).sum(0), upd[0][keep].sum(0), atol=1e-4)


def test_accumulate_validates_inputs():
    s = torch.zeros((2, 10), dtype=torch.int32)
    u = torch.zeros((2, 10, 16))
    with pytest.raises(ValueError):
        mo.accumulate(s, u, (64, 60))                   # 60 % 8 != 0
    with pytest.raises(ValueError):
        mo.accumulate(s, u, (64,))                      # L mismatch
    with pytest.raises(TypeError):
        mo.accumulate(s.long(), u, (64, 64))
    with pytest.raises(ValueError):
        mo.accumulate(s, u[:, :, :8], (64, 64))
    with pytest.raises(ValueError):
        mo.accumulate(s, u.transpose(0, 1).contiguous().transpose(0, 1),
                      (64, 64))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")


@pytest.mark.cuda
@pytest.mark.parametrize("hot", [False, True])
def test_accumulate_kernel_matches_plain_on_card(hot):
    """The CUDA kernel against its plain version at the bench shapes,
    with uniform slots and with 90% of the points on 4 slots: bitwise
    repeatable, and bitwise equal to the CPU's ascending-order sums."""
    _card()
    caps = (1 << 13, 1 << 15, 1 << 16)
    g = torch.Generator().manual_seed(int(hot))
    slots = torch.stack([torch.randint(0, c, (4096,), generator=g)
                         for c in caps])
    upd = torch.randn((3, 4096, 16), generator=g)
    if hot:
        slots = torch.where(torch.rand((3, 4096), generator=g) < 0.9,
                            torch.randint(0, 4, (3, 4096), generator=g), slots)
        upd[torch.rand((3, 4096), generator=g) < 0.1] = 0.0
    slots = slots.to(torch.int32).cuda()
    upd = upd.cuda()
    before = mo.counter.launches
    a = mo.accumulate(slots, upd, caps)
    assert mo.counter.launches == before + 1
    b = mo.accumulate(slots, upd, caps)
    cpu = mo.accumulate_ref(slots.cpu(), upd.cpu(), caps)
    torch.cuda.synchronize()
    for x, y, z in zip(a, b, cpu):
        assert torch.equal(x, y)                        # deterministic
        assert torch.equal(x.cpu(), z)                  # ascending-order sums


@pytest.mark.cuda
def test_insert_scan_fused_on_card_matches_cpu():
    """The map insert through the kernel on the card against the same
    insert on the CPU (plain version): keys and slots exact, statistics
    within the TestFusedInsert tolerances."""
    _card()
    from voxelslam_tpu_torch.config import small_test_config
    from voxelslam_tpu_torch.core import so3
    from voxelslam_tpu_torch.map import voxel_map as vm
    cfg = small_test_config().map
    rng = np.random.default_rng(0)
    R = so3.exp(t([0.1, -0.2, 0.3]))
    p = t([1.5, -0.7, 0.4])
    loc = t(rng.uniform(-4, 4, (600, 3)))
    mask = t(rng.random(600) > 0.1)
    nv = vm.point_noise_record(loc, 0.02, 0.05)
    out = {}
    for dev in ("cpu", "cuda"):
        levels = vm.empty_map(cfg, dev)
        args = [x.to(dev) for x in (loc @ R.T + p, loc, nv, mask)]
        out[dev] = vm.insert_scan_fused(levels, cfg, *args, 0, 1.0,
                                        R.to(dev), p.to(dev))
    for la, lb in zip(out["cpu"][0], out["cuda"][0]):
        assert torch.equal(la.keys, lb.keys.cpu())
        for f, tol in (("n", 1e-5), ("mu", 2e-4), ("S", 2e-3)):
            np.testing.assert_allclose(n(getattr(lb.win, f)),
                                       n(getattr(la.win, f)), atol=tol)
    for (sa, va, _), (sb, vb, _) in zip(out["cpu"][1], out["cuda"][1]):
        assert torch.equal(sa, sb.cpu()) and torch.equal(va, vb.cpu())
