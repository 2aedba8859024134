"""Waiver registry — acknowledged findings that must not gate synthesis;
the port's copy of ``repro/analyze/waivers.py``.

A waiver maps a finding ``id`` (``kind:stage.node`` — stable across runs,
no line numbers) to a human reason.  Waived findings stay in the report
(marked ``waived`` with the reason, so the artifact records the debt) but
stop counting toward the error total that fails
``synthesize(analyze=True)`` or the CLI exit code.
"""

from __future__ import annotations

from .report import Finding


class WaiverRegistry:
    def __init__(self, waivers: dict[str, str] | None = None):
        self._waivers: dict[str, str] = dict(waivers or {})

    def waive(self, finding_id: str, reason: str) -> None:
        if not reason or not reason.strip():
            raise ValueError(f"waiver for '{finding_id}' needs a reason")
        self._waivers[finding_id] = reason.strip()

    def reason(self, finding_id: str) -> str | None:
        return self._waivers.get(finding_id)

    def __len__(self) -> int:
        return len(self._waivers)

    def __contains__(self, finding_id: str) -> bool:
        return finding_id in self._waivers

    def apply(self, findings: list[Finding]) -> list[Finding]:
        """Mark waived findings in place; returns the same list."""
        for f in findings:
            reason = self._waivers.get(f.id)
            if reason is not None:
                f.waived = True
                f.waived_reason = reason
        return findings

    @classmethod
    def parse(cls, specs: list[str]) -> "WaiverRegistry":
        """CLI form: each spec is ``id=reason``."""
        reg = cls()
        for spec in specs:
            fid, sep, reason = spec.partition("=")
            if not sep:
                raise ValueError(
                    f"waiver '{spec}' is not of the form id=reason")
            reg.waive(fid.strip(), reason)
        return reg


__all__ = ["WaiverRegistry"]
