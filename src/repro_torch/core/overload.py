"""Overload-oriented scheduling (§7) — compatibility shim.

The admission policies live on the policy registry in
``repro_torch.core.policies.admission``; import from there (or build by
name via ``make_admission`` / ``get_policy("admission", name)``). This
module re-exports the public names, as the reference's
``core/overload.py`` does.
"""
from repro_torch.core.policies.admission import (  # noqa: F401
    AdmissionPolicy, BaselineAdmission, EarlyRejection,
    PredictiveEarlyRejection, make_admission)
