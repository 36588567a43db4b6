"""What one TU costs the hevc_walk kernel, by TU size and mode class.

Times the kernel at the 1080p slice's two shapes (tools/fixtures.py: B =
272 luma lanes of a 64x64 CTB, 544 chroma lanes of 32x32) on synthetic
states whose every lane is tiled with TUs of one size in one mode class,
and on a state without any TU, which gives the launch's fixed cost
(staging, the TU list, the store). Prints, per row, the time per launch and
the cycles per TU beyond the fixed cost at the SM clock read while the card
is busy. Each state is first held against walk_reference. Needs a GPU:

    python -m jmcodec_tpu_torch.tools.time_hevc_walk
"""

from __future__ import annotations

import numpy as np
import torch

from jmcodec_tpu_torch.kernels import hevc_walk as HW
from jmcodec_tpu_torch.tools.fixtures import BATCH, synth_state_hard
from jmcodec_tpu_torch.utils.device import (gpu_name_power, gpu_sm_clock_mhz,
                                            require_cuda)

# (C, max_tu, is_chroma, strong, lanes)
SHAPES = {"luma": (64, 32, False, True, BATCH * 17),
          "chroma": (32, 16, True, False, 2 * BATCH * 17)}
# mode classes: the modes a state draws from
MODES = {"planar": [0], "dc": [1], "angular >= 0": [2, 6, 10, 26, 30, 34],
         "angular < 0": [11, 14, 18, 22, 25], "any": list(range(35))}


def uniform_state(C, max_tu, B, n, modes, seed=0):
    """synth_state_hard's F, Z and residuals with every lane tiled by n x n
    TUs (n = 0: no TU) in modes drawn from `modes`."""
    F, Z, resid, tu, mode = synth_state_hard(C, max_tu, B, seed=seed)
    rng = np.random.default_rng(seed)
    tu[:] = 0
    if n:
        tu[:, ::n // 4, ::n // 4] = n.bit_length() - 1
    mode[:] = rng.choice(np.asarray(modes, np.int32), mode.shape)
    return F, Z, resid, tu, mode


def time_ms(fn, reps=30):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    # a spin kernel of a few ms lets the host queue the launches ahead, so
    # that its launch rate does not pace a kernel of a few us
    torch.cuda._sleep(int(2e5 * reps) + 4_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> None:
    dev = require_cuda()
    card = gpu_name_power()
    print(card)
    for name, (C, max_tu, chroma, strong, B) in SHAPES.items():
        kw = dict(C=C, max_tu=max_tu, is_chroma=chroma, strong=strong)

        def run(n, modes):
            st = uniform_state(C, max_tu, B, n, modes)
            args = [torch.from_numpy(a).to(dev) for a in st]
            got = HW.walk(*args, **kw)
            if not torch.equal(got, HW.walk_reference(*args, **kw)):
                raise RuntimeError(f"{name} n={n}: kernel != walk_reference")
            return args, time_ms(lambda: HW.walk(*args, **kw))

        args, fixed = run(0, [0])
        for _ in range(int(300 / fixed)):       # busy while the clock is read
            HW.walk(*args, **kw)
        mhz = gpu_sm_clock_mhz()
        torch.cuda.synchronize()
        print(f"{name} (B={B}, C={C}) [{card}, {mhz} MHz]: no TU "
              f"{fixed:.4f} ms per launch (fixed cost)")
        n = 4
        while n <= min(C, max_tu):
            tus = (C // n) ** 2
            for cls, modes in MODES.items():
                _, ms = run(n, modes)
                print(f"  {n:2d}x{n:<2d} x{tus:3d} {cls:13s} {ms:.4f} ms, "
                      f"{(ms - fixed) * 1e3 * mhz / tus:7.0f} cycles per TU")
            n *= 2


if __name__ == "__main__":
    main()
