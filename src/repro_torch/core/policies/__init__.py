"""Pluggable scheduling policies: Arm candidates, prefill/decode routing
and the serving loop's §7 admission — one string-keyed registry for all
three kinds.

    from repro_torch.core.policies import register_policy, list_policies

    @register_policy("prefill", "my_router")
    class MyRouter:
        def __init__(self, ctx): self.ctx = ctx
        def propose(self, req, instances, now): ...
"""
from repro_torch.core.policies.base import (Arm, DecodePolicy,  # noqa: F401
                                            PolicyContext, PrefillPolicy,
                                            get_policy, list_policies,
                                            register_policy)
from repro_torch.core.policies.admission import BackpressureSignal  # noqa: F401
from repro_torch.core.policies.routing import (  # noqa: F401
    CacheAwareRouting, KVCacheRouting, LoadBalanceRouting, RandomRouting,
    find_best_prefix, peer_fetch_arm, peer_ssd_arm, recompute_arm,
    ssd_load_arm)
from repro_torch.core.policies.load_aware import LoadAwareRouting  # noqa: F401
from repro_torch.core.policies.why_not_both import (  # noqa: F401
    WhyNotBothRouting)
from repro_torch.core.policies.decode import (KVPressureDecode,  # noqa: F401
                                              MinTBTDecode,
                                              SessionAffinityDecode)
