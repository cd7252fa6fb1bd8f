"""mfu.encode: the measured (untraced) window's encoder FLOPs over its seconds on the host
clock, as a share of the H100's bf16 peak. The FLOPs are those of the real (unpadded)
tokens of every passage encoded in the window (``harness.roofline.lengths_flops``), so
padding the port computes counts as waste."""

from harness.roofline import PEAK_OPS_S, lengths_flops


def read(run):
    lens = run.counters.get("encode_lengths")
    if not lens or not run.window_s:
        return None
    return 100.0 * lengths_flops(run.config, lens) / (run.window_s * PEAK_OPS_S["bf16"])
