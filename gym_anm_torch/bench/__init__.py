"""Measurement probes of the port's kernels on a card (not imported by the
package): ``python -m gym_anm_torch.bench.kernel_probes``."""
