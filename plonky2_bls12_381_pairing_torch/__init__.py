"""BLS12-381 optimal-ate pairing in PyTorch with hand-written CUDA kernels
for NVIDIA Hopper (the port of plonky2_bls12_381_pairing_tpu).

Entry points run on the CUDA device unless the caller passes device="cpu";
on the CPU every kernel is replaced by its plain PyTorch version.
"""
