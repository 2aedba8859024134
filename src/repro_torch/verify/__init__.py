"""Cross-backend verification; the port's counterpart of ``repro/verify``:
the fixed-point golden model, the seeded differential fuzz harness
(``python -m repro_torch.verify.difftest``) and the seeded chaos suite
(``python -m repro_torch.verify.chaos``).

The contract this package enforces:

* the float paths — ``ref`` (the unlowered ``create_top_module``), the
  eager backend and the generated CUDA stage kernel — agree to ≤ 1e-5 on
  every generated spec;
* the bit-accurate RTL simulator (``repro_torch.codegen.rtlsim``) is
  **bit-exact** against the independent fixed-point golden model here, word
  for word;
* the chaos suite injects every registered fault class and verifies
  containment (structured finish reasons, bit-identical survivors, bounded
  stalls).
"""

from .golden import fixed_forward


def __getattr__(name: str):
    # imported on first use: ``python -m repro_torch.verify.chaos`` must not
    # find the module already imported by its package, and the golden model
    # and difftest do not need the serving runtime that the suite drives
    if name == "run_suite":
        from .chaos import run_suite

        return run_suite
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["fixed_forward", "run_suite"]
