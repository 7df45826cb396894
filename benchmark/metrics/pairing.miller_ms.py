"""pairing.miller_ms: prepare_g2_stepmajor and miller_loop at the cell's
shapes, as multi_pairing runs them, captured alone: ms of a replay between
CUDA events (the system's captured_ms)."""


def measure(run, system, args):
    return system.captured_ms(system.miller_phase, *args)
