"""Mooncake's primary contribution: KVCache-centric disaggregated
scheduling — cache pool (Figure 3), Conductor (Algorithm 1), Messenger,
overload admission (§7), and the discrete-event cluster simulator (§8);
the port's public API, the reference's ``repro.core`` names with the H100
``Hardware`` where the reference exports its own default."""
from repro_torch.core.cache import (CachePool, StateCache,  # noqa: F401
                                    cache_hit_analysis, kv_block_bytes,
                                    ssm_state_bytes)
from repro_torch.core.tiered import TierPrefix, TieredCachePool  # noqa: F401
from repro_torch.core.directory import GlobalBlockDirectory  # noqa: F401
from repro_torch.core.conductor import (Conductor,  # noqa: F401
                                        DecodeInstance, PrefillInstance)
from repro_torch.core.costmodel import (H100, CostModel,  # noqa: F401
                                        Hardware, InstanceSpec)
from repro_torch.core.messenger import Messenger  # noqa: F401
from repro_torch.core.policies import (AdmissionPolicy, Arm,  # noqa: F401
                                       PolicyContext, get_policy,
                                       list_policies, make_admission,
                                       register_policy)
from repro_torch.core.simulator import (CoupledCluster,  # noqa: F401
                                        MooncakeCluster, SimResult)
from repro_torch.configs.base import CacheTierSpec, ClusterSpec  # noqa: F401
from repro_torch.core.trace import (BLOCK_TOKENS, Request,  # noqa: F401
                                    TraceSpec, generate_trace, load_trace,
                                    save_trace, simulated_requests,
                                    trace_stats)
