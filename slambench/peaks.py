"""The yardstick's peak and the bytes a kernel's work needs.

The HBM bandwidth of one NVIDIA H100 SXM (NVIDIA's data sheet, at the
700 W power limit; the run prints the card's limit beside it). The port's
two kernels are bound by bytes, not operations."""

HBM_BYTES_PER_S = 3.35e12

MOMENTS_KERNEL = "accumulate_kernel"   # csrc/moments.cu's kernel
MOMENTS_ROW_BYTES = 4 + 16 * 4         # an int32 slot and a 16-float row


def moments_bytes(valid_rows: int, levels: int) -> int:
    """Bytes that the moment accumulation of one scan needs at least: for
    each valid point (a downsampled point with its mask set) at each map
    level, its slot index and its packed 16-channel update row read once.
    The slots written are left out (their number is not visible outside
    the step's graph), so the share this gives is a lower bound of the
    kernel's share of its bytes roofline."""
    return int(valid_rows) * int(levels) * MOMENTS_ROW_BYTES
