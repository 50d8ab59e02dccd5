"""The moments kernel's wrapper (`voxelslam_tpu_torch.ops.moments`): its
dispatch and input checks on the CPU, the contract the CUDA kernel is held
to (ascending-order row sums, exact-zero rows skipped), and, on a card,
the CUDA kernel against its plain version. This file imports no
JAX, so the card tests run where JAX is absent:

    python -m pytest -m cuda --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from voxelslam_tpu_torch.ops import moments as mo

torch.set_num_threads(1)

BENCH_CAPS = (1 << 13, 1 << 15, 1 << 16)     # bench.py's MapConfig
DEFAULT_CAPS = (1 << 15, 1 << 16, 1 << 17)   # the default MapConfig


def t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def n(x):
    return x.detach().cpu().numpy()


def bits(x):
    """A float32 tensor's bits on the CPU, so that +0.0 and -0.0 differ."""
    return x.detach().cpu().contiguous().view(torch.int32)


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


@pytest.mark.parametrize("bad", ["cpu_tensors", "misaligned_upds",
                                 "misaligned_out", "out_shape"])
def test_launch_checks_raise(bad):
    """`launch` refuses what the kernel cannot take before it builds or
    calls anything: tensors off the card, rows not 16-byte aligned (the
    kernel reads and writes float4s), a wrong output table."""
    caps = (64, 64)
    s = torch.zeros((2, 10), dtype=torch.int32)
    u = torch.zeros((2, 10, 16))
    out = torch.empty((sum(caps), 16))
    if bad == "misaligned_upds":
        u = torch.zeros(2 * 10 * 16 + 1)[1:].view(2, 10, 16)
    elif bad == "misaligned_out":
        out = torch.empty(sum(caps) * 16 + 1)[1:].view(sum(caps), 16)
    elif bad == "out_shape":
        out = torch.empty((sum(caps) - 8, 16))
    match = {"cpu_tensors": "CUDA", "misaligned_upds": "aligned",
             "misaligned_out": "aligned", "out_shape": "out must"}[bad]
    mo._check(s, u, caps)
    with pytest.raises(ValueError, match=match):
        mo.launch(s, u, caps, out)


def _case(name):
    """(slots (L, P) int32, upds (L, P, 16) f32) numpy arrays and caps,
    made from a seed. uniform and hot: bench shapes as chip_smoke.py
    makes them; P*: one level-set at P points (P4097 and P20000 cross the
    kernel's 4096-point passes); L1/L8: one and eight levels; cap8 and
    cap1032: capacities of 8 and 1032 rows (no multiple of the tile);
    dropped: 30% of slots negative or >= C; slot0_signed_zeros: every
    point on slot 0, 80% of them rows of +-0.0; default_config: the
    default MapConfig/OdometryConfig shapes; small_hot: hot at small
    capacities, for the CPU tests."""
    rng = np.random.default_rng(sum(map(ord, name)))
    P, caps = 4096, BENCH_CAPS
    if name.startswith("P"):
        P = int(name[1:])
        caps = BENCH_CAPS if P > 1000 else (64, 128, 256)
    elif name == "L1":
        caps = (1024,)
    elif name == "L8":
        caps, P = (8, 16, 64, 264, 1032, 4096, 8, 520), 700
    elif name == "cap8":
        caps, P = (8, 8, 8), 100
    elif name == "cap1032":
        caps, P = (1032, 1032), 3000
    elif name == "default_config":
        caps, P = DEFAULT_CAPS, 8192
    elif name in ("dropped", "slot0_signed_zeros", "small_hot"):
        caps, P = (512, 1032, 264), 2000
    L = len(caps)
    slots = np.stack([rng.integers(0, c, P) for c in caps]).astype(np.int32)
    upd = rng.normal(size=(L, P, 16)).astype(np.float32)
    upd[:, :, 15] = 0.0
    if name in ("hot", "small_hot"):
        hot = rng.random((L, P)) < 0.9
        slots = np.where(hot, rng.integers(0, 4, (L, P)), slots)
        upd[rng.random((L, P)) < 0.1] = 0.0
    elif name == "dropped":
        far = np.array(caps)[:, None] + rng.integers(0, 5000, (L, P))
        neg = -rng.integers(1, 2**31 - 1, (L, P))
        side = rng.random((L, P)) < 0.5
        slots = np.where(rng.random((L, P)) < 0.3,
                         np.where(side, far, neg), slots)
    elif name == "slot0_signed_zeros":
        slots[:] = 0
        z = rng.random((L, P)) < 0.8
        sign = np.where(rng.random((L, P, 16)) < 0.5, -1.0, 1.0)
        upd[z] = (0.0 * sign[z]).astype(np.float32)
    return slots.astype(np.int32), upd, caps


@pytest.mark.parametrize("name", ["small_hot", "dropped",
                                  "slot0_signed_zeros"])
def test_accumulate_ref_is_sequential_ascending_sum(name):
    """The contract the kernel is held to: on the CPU `accumulate_ref`
    adds each row's points one at a time in ascending index, bitwise, and
    drops out-of-range slots. Hot rows make the order visible."""
    slots, upd, caps = _case(name)
    ref = mo.accumulate_ref(t(slots, torch.int32), t(upd), caps)
    for l, c in enumerate(caps):
        table = np.zeros((c, 16), np.float32)
        for i in range(slots.shape[1]):
            s = int(slots[l, i])
            if 0 <= s < c:
                table[s] = table[s] + upd[l, i]         # float32 adds
        assert torch.equal(bits(ref[l]), bits(torch.from_numpy(table)))


@pytest.mark.parametrize("how", ["packed_w0", "signed_zero_rows"])
def test_skipping_zero_rows_is_bitwise_exact(how):
    """Leaving out every point whose 16 values are all +-0.0 leaves the
    tables bitwise unchanged: a sum that starts at +0.0 never becomes -0.0.
    The map insert's padded points are such rows, and w = 0 times a
    negative q gives -0.0 (`pack_updates`)."""
    rng = np.random.default_rng(3)
    caps, P = (64, 256), 600
    slots = np.stack([rng.integers(0, c, P) for c in caps]).astype(np.int32)
    slots[:, ::3] = 0                                   # slot 0 gets the pads
    if how == "packed_w0":
        q = rng.uniform(-0.5, 0.5, (P, 3)).astype(np.float32)
        nv = rng.normal(0, 1e-3, (P, 5)).astype(np.float32)
        w = (rng.random(P) > 0.4).astype(np.float32)
        row = mo.pack_updates(t(q), t(nv), t(w))
        upd = torch.stack([row, 0.5 * row]).contiguous()
    else:
        upd = t(rng.normal(size=(2, P, 16)))
        z = t(rng.random((2, P)) < 0.5, torch.bool)
        sign = torch.where(t(rng.random((2, P, 16))) < 0.5, -1.0, 1.0)
        upd[z] = 0.0 * sign[z]
    zero = (upd == 0).all(dim=2)
    assert zero.any() and bool(torch.signbit(upd[zero]).any())
    st = t(slots, torch.int32)
    full = mo.accumulate_ref(st, upd, caps)
    for l, c in enumerate(caps):
        keep = ~zero[l]
        kept = mo.accumulate_ref(st[l][keep][None].contiguous(),
                                 upd[l][keep][None].contiguous(), (c,))[0]
        assert torch.equal(bits(full[l]), bits(kept))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc to build the kernel)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["uniform", "hot", "P1", "P33", "P4097",
                                  "P20000", "L1", "L8", "cap8", "cap1032",
                                  "dropped", "slot0_signed_zeros",
                                  "default_config"])
def test_accumulate_kernel_matches_plain_on_card(name):
    """The CUDA kernel against its plain version (see `_case` for the
    inputs): one launch a call, bitwise repeatable, and bitwise equal to
    the CPU's ascending-order sums, signed zeros included."""
    _card()
    slots, upd, caps = _case(name)
    slots = t(slots, torch.int32).cuda()
    upd = t(upd).cuda()
    before = mo.counter.launches
    a = mo.accumulate(slots, upd, caps)
    assert mo.counter.launches == before + 1
    b = mo.accumulate(slots, upd, caps)
    cpu = mo.accumulate_ref(slots.cpu(), upd.cpu(), caps)
    torch.cuda.synchronize()
    for x, y, z in zip(a, b, cpu):
        assert torch.equal(bits(x), bits(y))            # deterministic
        assert torch.equal(bits(x), bits(z))            # ascending-order sums


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
