"""Cross-backend verification; the port's counterpart of ``repro/verify``:
the fixed-point golden model and the seeded differential fuzz harness
(``python -m repro_torch.verify.difftest``).

The contract this package enforces:

* the float paths — ``ref`` (the unlowered ``create_top_module``), the
  eager backend and the generated CUDA stage kernel — agree to ≤ 1e-5 on
  every generated spec;
* the bit-accurate RTL simulator (``repro_torch.codegen.rtlsim``) is
  **bit-exact** against the independent fixed-point golden model here, word
  for word.
"""

from .golden import fixed_forward

__all__ = ["fixed_forward"]
