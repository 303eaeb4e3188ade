"""Sizes at which the CPU tests run each cell: the port's plain versions
on the CPU, four gloo processes for the four-card cell. Each size keeps
what the controls need to show: pairs whose keys share their top 24 bits,
and prefix sums past float32's 2^24."""

OVERRIDES = {
    "u32_2p28_1card.sort_uniform": {"config": {"n": 1 << 16}},
    "u32_small_1card.sort_closed": {"config": {"n_min": 16, "n_max": 65536},
                                    "traffic": {"pool": 8, "warmup_steps": 8, "sampled_steps": 4,
                                                "sample_within": 32, "trace_steps": 8}},
    "u32_2p28_1card.scan_reduce": {"config": {"n": 1 << 22}},
    "u32_2p30_4card.dist_sort_skew": {"config": {"n": 1 << 14}},
}
SECONDS = 0.3


def run(name: str, seed: int = 2**31 + 11, trace: bool = False, patch: str | None = None) -> dict:
    import time

    from benchmark import harness

    return harness.run_cell(name, seed, SECONDS, trace, t_start=time.time(), device_type="cpu",
                            overrides=OVERRIDES[name], patch=patch)
