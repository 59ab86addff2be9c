"""``step_mfu``: the whole step's share of the cards' peak (%): 3 × the
frozen forward FLOPs × the images of a step over the step's seconds
(the traced run's window, outside the profiled stretch) and the cards'
bf16 peak. Recomputation is not counted."""


def read(run: dict) -> float | None:
    if run["peak_flops"] is None:
        return None
    return 100.0 * run["flops_per_step"] / run["step_s"] / (
        run["peak_flops"] * run["chips"])
