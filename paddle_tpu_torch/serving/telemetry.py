"""Serving metric instruments — the subset of
``paddle_tpu/serving/telemetry.py`` that the engine and the router of
this package emit (same names, labels and help texts: health rules and
degradation signals read metrics by name). Request-relative timings
(TTFT, inter-token latency, queue wait) use the ENGINE clock; host work
timings (tick, drain) the real monotonic clock.

Every tenant-labeled write goes through :func:`tenant_label`, the
cardinality guard: past ``PT_TENANT_LABEL_CAP`` distinct tenants the
label collapses to ``__overflow__`` (counted in
``serving_tenant_label_overflow_total``), so a tenant-id-fuzzing client
cannot grow the registry or the Prometheus export without bound.
"""
import os

from paddle_tpu_torch.observability import METRICS

_ADMITTED = METRICS.counter(
    "serving_admissions_total", "requests admitted into cache slots")
_PREEMPTED = METRICS.counter(
    "serving_preemptions_total", "requests evicted and re-queued")
_TIMEOUTS = METRICS.counter(
    "serving_timeouts_total", "requests expired (deadline_s/max_queue_s)")
_CANCELLED = METRICS.counter(
    "serving_cancellations_total", "requests cancelled by the caller")
_REJECTED = METRICS.counter(
    "serving_rejections_total", "admissions refused at intake",
    labelnames=("reason",))
_TOKENS = METRICS.counter(
    "serving_tokens_total", "tokens sampled and emitted")
_FINISHED = METRICS.counter(
    "serving_finished_total", "requests finished, by finish_reason",
    labelnames=("reason",))
_QUEUE_DEPTH = METRICS.gauge(
    "serving_queue_depth", "requests waiting for admission")
_ACTIVE_SLOTS = METRICS.gauge(
    "serving_active_slots", "cache slots actively decoding")
_KV_IN_USE = METRICS.gauge(
    "serving_kv_blocks_in_use", "paged KV blocks currently allocated")
_KV_UTIL = METRICS.gauge(
    "serving_kv_block_utilization", "allocated fraction of the KV pool")
_TTFT = METRICS.histogram(
    "serving_ttft_seconds", "submission → first token (engine clock)")
_TOK_LAT = METRICS.histogram(
    "serving_token_latency_seconds", "inter-token gap (engine clock)",
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5))
_QUEUE_WAIT = METRICS.histogram(
    "serving_queue_wait_seconds", "submission → admission (engine clock)")
_TICK = METRICS.histogram(
    "serving_tick_seconds", "wall time of one engine tick")
_DRAIN = METRICS.histogram(
    "serving_drain_seconds", "wall time of graceful drain",
    buckets=(0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0))
# decode-tick anatomy: every tick observes all five phases (zero seconds
# included), so per phase count == tick count and the five observations
# of a tick sum to that tick's serving_tick_seconds observation by
# construction — host is defined as the remainder
_TICK_BREAKDOWN = METRICS.histogram(
    "serving_tick_breakdown_seconds",
    "per-tick wall time by phase: prefill (admission + chunk forwards), "
    "draft, verify, sample (the fused decode forward + token fetch), "
    "host (everything else in the tick)",
    labelnames=("phase",),
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5))
# prefix cache: cumulative adopt/evict counts exported from the block
# manager's cache_stats (deltas pushed each gauge refresh), plus the
# lifetime hit rates
_PREFIX_HITS = METRICS.counter(
    "serving_prefix_hit_blocks_total",
    "prompt blocks adopted from the prefix cache instead of prefilled")
_PREFIX_EVICTIONS = METRICS.counter(
    "serving_prefix_evictions_total",
    "parked prefix blocks evicted to satisfy new allocations")
_PREFIX_HIT_RATE = METRICS.gauge(
    "serving_prefix_hit_rate",
    "prefix-cache hit blocks / prompt blocks requested (lifetime)")
_PREFIX_TOKEN_HITS = METRICS.counter(
    "serving_prefix_token_hits_total",
    "prompt tokens served from the prefix cache (full-block shares plus "
    "partial copy-on-write boundary hits) instead of prefilled")
_PREFIX_PARTIAL_HITS = METRICS.counter(
    "serving_prefix_partial_hits_total",
    "partially-filled boundary blocks adopted copy-on-write from the "
    "radix trie")
_PREFIX_TOKEN_HIT_RATE = METRICS.gauge(
    "serving_prefix_token_hit_rate",
    "prefix-cache hit tokens / prompt tokens probed (lifetime)")
# async pipelined decode
_ASYNC_DEPTH = METRICS.gauge(
    "serving_async_depth",
    "configured decode pipeline depth (dispatched-but-unfetched ticks "
    "kept in flight; 0 = fully synchronous)")
_ASYNC_DRAINS = METRICS.counter(
    "serving_async_drains_total",
    "async decode windows drained before a tick the pipeline cannot "
    "cover, by cause (admit, prefill, beam, grammar, adapter, window, "
    "spec, growth, finish, cancel, exception, boundary)",
    labelnames=("why",))
# under async decode, the breakdown's `host` phase reports only EXPOSED
# host time; host work done while dispatched ticks were still in flight
# lands here instead (one observation per tick)
_TICK_HIDDEN = METRICS.histogram(
    "serving_tick_host_hidden_seconds",
    "per-tick host work (token emission, stream callbacks, finish "
    "bookkeeping) performed while async-dispatched device ticks were "
    "still in flight — hidden time, excluded from the breakdown's "
    "exposed `host` phase",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5))
# speculative decoding: proposal/acceptance accounting plus the per-tick
# commit size — tokens_per_tick > 1 is the whole point
_SPEC_PROPOSED = METRICS.counter(
    "serving_spec_proposed_total", "draft tokens proposed for verification")
_SPEC_ACCEPTED = METRICS.counter(
    "serving_spec_accepted_total", "draft tokens accepted by the target")
_SPEC_FALLBACKS = METRICS.counter(
    "serving_spec_fallbacks_total",
    "spec ticks abandoned before verify (fault injection) — the engine "
    "fell back to the one-token tick")
_SPEC_RATE = METRICS.gauge(
    "serving_spec_acceptance_rate",
    "cumulative accepted/proposed draft-token ratio")
_SPEC_TOKENS = METRICS.histogram(
    "serving_spec_tokens_per_tick",
    "tokens committed per slot per speculative tick",
    buckets=(1, 2, 3, 4, 5, 6, 8, 12, 16))
_SPEC_DRAFT_REUSE = METRICS.counter(
    "serving_spec_draft_reuse_tokens_total",
    "draft-cache positions adopted from a slot's resident draft K/V at "
    "activation (radix prefix hits whose draft-side re-prefill was "
    "skipped entirely)")
# adapter cache (batched multi-LoRA): device-resident stacked A/B slots
_ADAPTER_UPLOADS = METRICS.counter(
    "serving_adapter_uploads_total",
    "host→device adapter uploads into the stacked LoRA cache")
_ADAPTER_EVICTIONS = METRICS.counter(
    "serving_adapter_evictions_total",
    "resident adapters evicted (LRU) to make room for an upload")
_ADAPTER_HITS = METRICS.counter(
    "serving_adapter_cache_hits_total",
    "adapter lookups served by the device-resident cache")
_ADAPTER_MISSES = METRICS.counter(
    "serving_adapter_cache_misses_total",
    "adapter lookups that required a host→device upload")
_ADAPTER_RESIDENT = METRICS.gauge(
    "serving_adapter_resident", "adapters resident in the device cache")
_ADAPTER_DEFERRALS = METRICS.counter(
    "serving_adapter_admit_deferrals_total",
    "admissions deferred because the adapter could not be made resident "
    "(cache fully pinned, or an injected serving.adapter_swap fault)")
# grammar-constrained decoding: mask bookkeeping
_GRAMMAR_TOKENS = METRICS.counter(
    "serving_grammar_tokens_total",
    "tokens emitted under a grammar mask (all mask-legal by construction)")
_GRAMMAR_SPEC_REJECTS = METRICS.counter(
    "serving_grammar_spec_rejects_total",
    "drafted tokens rejected by the grammar mask before the target "
    "accept rule was consulted")

# ------------------------------------------------------- multi-tenancy
# per-tenant accounting: the fair scheduler charges token budgets at
# admission and these break the engine's aggregate goodput/waste story
# down by tenant — a saturating tenant's waste must not hide in totals
_TENANT_TOKENS = METRICS.counter(
    "serving_tenant_tokens_total", "tokens emitted, by tenant",
    labelnames=("tenant",))
_TENANT_ADMITTED = METRICS.counter(
    "serving_tenant_admissions_total", "requests admitted, by tenant",
    labelnames=("tenant",))
_TENANT_QUEUE_WAIT = METRICS.histogram(
    "serving_tenant_queue_wait_seconds",
    "submission → admission (engine clock), by tenant",
    labelnames=("tenant",))
_TENANT_WASTE = METRICS.counter(
    "serving_tenant_waste_tokens_total",
    "wasted work, by tenant and cause (replay_prefill, spec_rejected)",
    labelnames=("tenant", "why"))
# per-tenant SLO inputs: the SLOTracker computes burn rates from
# windowed deltas of these — latency objectives from the tenant
# histograms, availability from finished{reason} + rejections
_TENANT_TTFT = METRICS.histogram(
    "serving_tenant_ttft_seconds",
    "submission → first token (engine clock), by tenant",
    labelnames=("tenant",))
_TENANT_TOK_LAT = METRICS.histogram(
    "serving_tenant_token_latency_seconds",
    "inter-token gap (engine clock), by tenant",
    labelnames=("tenant",),
    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
             1.0, 2.5))
_TENANT_FINISHED = METRICS.counter(
    "serving_tenant_finished_total",
    "requests finished, by tenant and finish_reason",
    labelnames=("tenant", "reason"))
_TENANT_REJECTED = METRICS.counter(
    "serving_tenant_rejections_total",
    "admissions refused at intake for requests carrying a tenant_id, "
    "by tenant", labelnames=("tenant",))

# ------------------------------------- tenant label-cardinality guard
_TENANT_OVERFLOW = METRICS.counter(
    "serving_tenant_label_overflow_total",
    "tenant-labeled metric writes collapsed into the __overflow__ label "
    "because the distinct-tenant cap (PT_TENANT_LABEL_CAP) was reached")

TENANT_OVERFLOW_LABEL = "__overflow__"
_tenant_labels_seen: set = set()


def tenant_label(tenant) -> str:
    """The label value for one tenant-labeled metric write. Returns
    ``str(tenant)`` for the first ``PT_TENANT_LABEL_CAP`` (default 64)
    distinct tenants seen by this process, then collapses every new
    tenant id to ``__overflow__`` and counts the collapse — bounding
    registry cardinality against tenant-id fuzzing. The cap is read per
    call so tests (and operators) can change it mid-flight."""
    t = str(tenant)
    if t in _tenant_labels_seen:
        return t
    try:
        cap = int(os.environ.get("PT_TENANT_LABEL_CAP", "64"))
    except ValueError:
        cap = 64
    if len(_tenant_labels_seen) < cap:
        _tenant_labels_seen.add(t)
        return t
    _TENANT_OVERFLOW.inc()
    return TENANT_OVERFLOW_LABEL


def reset_tenant_labels():
    """Forget the seen-tenant set (test hygiene, so one test's tenants
    cannot exhaust another's cap)."""
    _tenant_labels_seen.clear()


# ------------------------------------------------ graceful degradation
# the reaction layer: the ladder's rung and transitions, and the
# shed/throttle skips at admission
_DEGRADE_LEVEL = METRICS.gauge(
    "serving_degrade_level",
    "current degradation-ladder rung: 0 none, 1 spec off, 2 prefill "
    "budget shrunk, 3 best-effort tenants shed, 4 new sessions rejected")
_DEGRADE_TRANSITIONS = METRICS.counter(
    "serving_degrade_transitions_total",
    "degradation-ladder transitions, by direction (up/down) and target "
    "rung", labelnames=("direction", "to"))
_DEGRADE_SHED = METRICS.counter(
    "serving_degrade_shed_total",
    "admission passes that skipped a best-effort tenant while the "
    "ladder held L3+ (requests stay queued and admit on recovery)",
    labelnames=("tenant",))
_TENANT_THROTTLED = METRICS.counter(
    "serving_tenant_throttled_total",
    "admission passes that skipped a tenant whose token bucket was "
    "empty (max_tokens_per_s rate limit), by tenant",
    labelnames=("tenant",))

# ------------------------------------------------------------- router
_R_DISPATCH = METRICS.counter(
    "router_dispatch_total", "requests dispatched to a replica",
    labelnames=("replica",))
_R_REQUEUES = METRICS.counter(
    "router_requeues_total",
    "requests pulled back from a replica and re-dispatched, by replica "
    "and cause (replica_death, kv_transfer, dispatch_fault, drain)",
    labelnames=("replica", "why"))
_R_OUTSTANDING = METRICS.gauge(
    "router_replica_outstanding", "not-yet-finished requests per replica",
    labelnames=("replica",))
_R_HEALTH = METRICS.gauge(
    "router_replica_health",
    "per-replica health verdict (0 OK / 1 WARN / 2 CRIT)",
    labelnames=("replica",))
_R_TRANSFERS = METRICS.counter(
    "router_kv_transfers_total",
    "prefilled sequences shipped prefill→decode (disaggregated mode)")
_R_TRANSFER_BLOCKS = METRICS.counter(
    "router_kv_transfer_blocks_total",
    "KV blocks shipped prefill→decode (disaggregated mode)")
_R_DEATHS = METRICS.counter(
    "router_replica_deaths_total", "replicas declared dead by the router")

# session durability and the hardened KV handoff (retries, hedging,
# the delivery-time histogram the hedging deadline reads)
_SNAPSHOTS = METRICS.counter(
    "serving_session_snapshots_total",
    "host-side session-durability snapshots captured")
_R_RESTORES = METRICS.counter(
    "router_session_restores_total",
    "sessions restored from a snapshot onto a surviving replica after "
    "a repeat replica death (instead of failing with replica_death)")
_R_TRANSFER_RETRIES = METRICS.counter(
    "router_transfer_retries_total",
    "KV-handoff ship attempts retried, by replica and cause (partial = "
    "failed geometry/checksum validation, error = transport exception)",
    labelnames=("replica", "why"))
_R_HEDGES = METRICS.counter(
    "router_hedges_total",
    "KV handoffs re-dispatched to another decode replica after the "
    "primary ship blew its p95-derived deadline (straggler hedging)")
_R_HEDGE_RATE = METRICS.gauge(
    "router_hedge_rate",
    "lifetime hedged / successful KV handoffs — sustained hedging "
    "means a straggling replica or transport link")
_R_TRANSFER_SECONDS = METRICS.histogram(
    "router_kv_transfer_seconds",
    "wall time of one successful KV-handoff delivery (ship + "
    "validation) — feeds the p95-derived hedging deadline",
    buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
             0.25, 0.5, 1.0, 2.5))
