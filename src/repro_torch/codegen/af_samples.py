"""The activation ROMs' samples: float32 values of ``tanh``, ``sigmoid``,
``gelu`` (tanh approximation) and ``silu`` at the 64 bin centres
``(i + 0.5) / 64 * 8 - 4`` of the ROM domain [-4, 4), as the reference's
``jax.numpy``/``jax.nn`` functions give them, written as hex literals.

The Verilog AF ROMs, rtlsim's ROM words, the golden model's tables and the
analyzer's ROM bounds all quantize these numbers.  They are not recomputed
with torch: ``torch.tanh``, ``torch.sigmoid``, ``F.gelu`` and ``F.silu``
differ from them in the last float32 bits at up to 40 of the 64 centres, which
changes the ROM words at widths of 23 bits and more.  ``relu`` and
``identity`` have no ROM (they are combinational in the RTL).
"""

from __future__ import annotations

AF_ADDR_BITS = 6  # 64-entry activation ROMs (paper §IV-B)

_HEX: dict[str, tuple[str, ...]] = {
    "gelu": (
        "-0x1.8b3ap-14", "-0x1.5d52p-13", "-0x1.2ca58p-12", "-0x1.f7dfp-12",
        "-0x1.9bcd4p-11", "-0x1.487b2p-10", "-0x1.ffc4ap-10", "-0x1.85a1ap-9",
        "-0x1.2216fp-8", "-0x1.a6a918p-8", "-0x1.2d799cp-7", "-0x1.a54e58p-7",
        "-0x1.208178p-6", "-0x1.836958p-6", "-0x1.fe36cep-6", "-0x1.49943cp-5",
        "-0x1.a1bd86p-5", "-0x1.03bbe8p-4", "-0x1.3cd2bcp-4", "-0x1.7af5ap-4",
        "-0x1.bc3bf4p-4", "-0x1.fdecc2p-4", "-0x1.1e3a7cp-3", "-0x1.39b5d4p-3",
        "-0x1.4ed42ep-3", "-0x1.5ab64cp-3", "-0x1.5a4faep-3", "-0x1.4a8c68p-3",
        "-0x1.287c2ap-3", "-0x1.e2fea8p-4", "-0x1.46e388p-4", "-0x1.e67cp-6",
        "0x1.0cc2p-5", "0x1.b91c7ap-4", "0x1.8e80acp-3", "0x1.2bc1eap-2",
        "0x1.9ab9ccp-2", "0x1.096c14p-1", "0x1.49526cp-1", "0x1.8c4af4p-1",
        "0x1.d1928cp-1", "0x1.0c38b2p+0", "0x1.302134p+0", "0x1.543c4p+0",
        "0x1.7850a6p+0", "0x1.9c32d4p+0", "0x1.bfc442p+0", "0x1.e2f214p+0",
        "0x1.02d9bp+1", "0x1.140392p+1", "0x1.24f92ep+1", "0x1.35befep+1",
        "0x1.465ab2p+1", "0x1.56d288p+1", "0x1.672caap+1", "0x1.776ef4p+1",
        "0x1.879e98p+1", "0x1.97c006p+1", "0x1.a7d6f2p+1", "0x1.b7e642p+1",
        "0x1.c7f042p+1", "0x1.d7f69cp+1", "0x1.e7fa8ap+1", "0x1.f7fce8p+1",
    ),
    "sigmoid": (
        "0x1.395406p-6", "0x1.622546p-6", "0x1.9025dep-6", "0x1.c3f51p-6",
        "0x1.fe42bp-6", "0x1.1fe816p-5", "0x1.44b8acp-5", "0x1.6e0692p-5",
        "0x1.9c4efcp-5", "0x1.d018cp-5", "0x1.04fa04p-4", "0x1.253cdp-4",
        "0x1.4924ecp-4", "0x1.71055ap-4", "0x1.9d32e8p-4", "0x1.ce028ep-4",
        "0x1.01e3ccp-3", "0x1.1f689cp-3", "0x1.3fb3eep-3", "0x1.62e4ecp-3",
        "0x1.89140ep-3", "0x1.b2512p-3", "0x1.dea172p-3", "0x1.06fef8p-2",
        "0x1.2028ccp-2", "0x1.3abc1p-2", "0x1.569e9cp-2", "0x1.73ae32p-2",
        "0x1.91c0cp-2", "0x1.b0a50ep-2", "0x1.d023ep-2", "0x1.f00152p-2",
        "0x1.07ff56p-1", "0x1.17ee1p-1", "0x1.27ad78p-1", "0x1.371fa2p-1",
        "0x1.4628e6p-1", "0x1.54b0b2p-1", "0x1.62a1f8p-1", "0x1.6feb9ap-1",
        "0x1.7c8082p-1", "0x1.8857a4p-1", "0x1.936bb8p-1", "0x1.9dbafcp-1",
        "0x1.a746c4p-1", "0x1.b01306p-1", "0x1.b825d8p-1", "0x1.bf870cp-1",
        "0x1.c63faep-1", "0x1.cc59a2p-1", "0x1.d1df54p-1", "0x1.d6db64p-1",
        "0x1.db5866p-1", "0x1.df60cp-1", "0x1.e2fe74p-1", "0x1.e63b1p-1",
        "0x1.e91f98p-1", "0x1.ebb476p-1", "0x1.ee017ep-1", "0x1.f00decp-1",
        "0x1.f1e05ap-1", "0x1.f37edp-1", "0x1.f4eed8p-1", "0x1.f6356p-1",
    ),
    "silu": (
        "-0x1.346eb6p-4", "-0x1.518b86p-4", "-0x1.70e2e8p-4", "-0x1.928642p-4",
        "-0x1.b6815p-4", "-0x1.dcd864p-4", "-0x1.02c32ap-3", "-0x1.183d08p-3",
        "-0x1.2eca02p-3", "-0x1.465168p-3", "-0x1.5eaff6p-3", "-0x1.77b5eap-3",
        "-0x1.9125p-3", "-0x1.aaae3p-3", "-0x1.c3efaep-3", "-0x1.dc72a2p-3",
        "-0x1.f3a95cp-3", "-0x1.0476cep-2", "-0x1.0dbfdp-2", "-0x1.1542d8p-2",
        "-0x1.1a866ap-2", "-0x1.1d053cp-2", "-0x1.1c2fdcp-2", "-0x1.176ee8p-2",
        "-0x1.0e264p-2", "-0x1.ff719ap-3", "-0x1.d71a16p-3", "-0x1.a223f8p-3",
        "-0x1.5f88a8p-3", "-0x1.0e6728p-3", "-0x1.5c1ae8p-4", "-0x1.f00152p-6",
        "0x1.07ff56p-5", "0x1.a3e518p-4", "0x1.7198d6p-3", "0x1.103baep-2",
        "0x1.6eee02p-2", "0x1.d472f4p-2", "0x1.20239ap-1", "0x1.58ecep-1",
        "0x1.94488ap-1", "0x1.d1e812p-1", "0x1.08bebp+0", "0x1.295e66p+0",
        "0x1.4aaf4ap+0", "0x1.6c900ep+0", "0x1.8ee24cp+0", "0x1.b18ad4p+0",
        "0x1.d471acp+0", "0x1.f7820ap+0", "0x1.0d551cp+1", "0x1.1eedbp+1",
        "0x1.3084a2p+1", "0x1.4215p+1", "0x1.539aeap+1", "0x1.65136p+1",
        "0x1.767c3p+1", "0x1.87d3cep+1", "0x1.99193cp+1", "0x1.aa4bf6p+1",
        "0x1.bb6bdp+1", "0x1.cc78e8p+1", "0x1.dd73a6p+1", "0x1.ee5c8ap+1",
    ),
    "tanh": (
        "-0x1.ff9c64p-1", "-0x1.ff801ep-1", "-0x1.ff5bcep-1", "-0x1.ff2d38p-1",
        "-0x1.fef16ap-1", "-0x1.fea4a6p-1", "-0x1.fe422cp-1", "-0x1.fdc3dp-1",
        "-0x1.fd21c2p-1", "-0x1.fc51f8p-1", "-0x1.fb47ap-1", "-0x1.f9f276p-1",
        "-0x1.f83daap-1", "-0x1.f60efcp-1", "-0x1.f34522p-1", "-0x1.efb63cp-1",
        "-0x1.eb2dfep-1", "-0x1.e56b6ep-1", "-0x1.de1eb6p-1", "-0x1.d4e6f6p-1",
        "-0x1.c950a2p-1", "-0x1.bad50ap-1", "-0x1.a8dbcep-1", "-0x1.92bfb2p-1",
        "-0x1.77d83cp-1", "-0x1.5789p-1", "-0x1.3157ep-1", "-0x1.05087p-1",
        "-0x1.a572ap-2", "-0x1.35f98ap-2", "-0x1.7b8ff6p-3", "-0x1.ff5596p-5",
        "0x1.ff5596p-5", "0x1.7b8ff6p-3", "0x1.35f98ap-2", "0x1.a572ap-2",
        "0x1.05087p-1", "0x1.3157ep-1", "0x1.5789p-1", "0x1.77d83cp-1",
        "0x1.92bfb2p-1", "0x1.a8dbcep-1", "0x1.bad50ap-1", "0x1.c950a2p-1",
        "0x1.d4e6f6p-1", "0x1.de1eb6p-1", "0x1.e56b6ep-1", "0x1.eb2dfep-1",
        "0x1.efb63cp-1", "0x1.f34522p-1", "0x1.f60efcp-1", "0x1.f83daap-1",
        "0x1.f9f276p-1", "0x1.fb47ap-1", "0x1.fc51f8p-1", "0x1.fd21c2p-1",
        "0x1.fdc3dp-1", "0x1.fe422cp-1", "0x1.fea4a6p-1", "0x1.fef16ap-1",
        "0x1.ff2d38p-1", "0x1.ff5bcep-1", "0x1.ff801ep-1", "0x1.ff9c64p-1",
    ),
}

#: fn -> the 64 samples, bin 0 first (float32 values held as Python floats)
SAMPLES: dict[str, tuple[float, ...]] = {
    fn: tuple(float.fromhex(h) for h in hexes) for fn, hexes in _HEX.items()}


def samples(fn: str) -> tuple[float, ...]:
    """The 64 samples of ROM activation ``fn``; raises for a function
    without a ROM."""
    try:
        return SAMPLES[fn]
    except KeyError:
        raise ValueError(f"activation '{fn}' has no ROM samples; ROM activations: "
                         f"{sorted(SAMPLES)}") from None


__all__ = ["AF_ADDR_BITS", "SAMPLES", "samples"]
