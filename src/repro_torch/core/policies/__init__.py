"""Engine-side admission policies on a string-keyed registry."""
from repro_torch.core.policies.admission import BackpressureSignal  # noqa: F401
from repro_torch.core.policies.base import get_policy  # noqa: F401
