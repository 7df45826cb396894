"""pairing.final_exp_ms: final_exponentiation at the cell's rows, on the
Miller loop's output of the first batch, captured alone: ms of a replay
between CUDA events (the system's captured_ms)."""


def measure(run, system, args):
    from plonky2_bls12_381_pairing_torch.models import pairing_rns

    f = system.miller_phase(*args)
    return system.captured_ms(pairing_rns.final_exponentiation, f)
