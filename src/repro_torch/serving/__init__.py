"""Serving substrate of the port: paged device KV cache, chunked-prefill
and continuous-batching engines, the serving loop, CPP pipelined prefill
(§5.1) and layer-wise prefill semantics (§5.2) — the reference's
exports (``repro/serving/__init__.py``)."""
from repro_torch.serving.engine import (ChunkedPrefill, DecodeWorker,
                                        FetchPlan, HostKVPool, PeerSource,
                                        PrefillResult, PrefillWorker,
                                        PrefixHasher, StateCheckpointWorker,
                                        connect_pools, prefix_hash_ids,
                                        stage_run)
from repro_torch.serving.layerwise import occupation_cost, schedule
from repro_torch.serving.loop import RequestOutput, ServingLoop
from repro_torch.serving.paged_cache import (DevicePagePool, PagedKVCache,
                                             assign_seq, free_seq, gather_kv,
                                             grow_seq, init_paged_cache,
                                             write_kv)
