"""Leakage-tiered security profiles (DESIGN.md §14); a copy of the JAX
package's `repro.sec.profiles`, which imports nothing of JAX.

A `SecurityProfile` names one point on the leakage-vs-QPS frontier: how
much of the server's *observable behaviour* — batch shapes, result
sizes, which rows a scan touches — is flattened so it stops being a
function of the plaintext workload.  The ciphertext story (DCPE filter
+ DCE refine, and the keyless ADC codes derived from the DCPE
ciphertexts) is identical under every profile; profiles only change the
side channels around it:

  perf              the engine with no flattening.  Batches pad
                    by replicating a real query, results carry exactly
                    the requested k columns, IVF scans touch only the
                    probed partitions.  Fastest; the trace/wire
                    observables correlate with the workload.
  balanced          wire observables flattened at ~zero compute cost:
                    batch padding rows are *dummy* (zero) queries
                    riding the existing row-validity stream, and result
                    ids are padded to a power-of-two column bucket so
                    result count / requested k never leak.  The scan
                    itself is unchanged.
  hardened          balanced + access-pattern flattening: every flush
                    pads to the full warmup-compiled `max_batch` bucket
                    (batch size never leaks, still zero recompiles) and
                    IVF/ADC filters run the scan-oblivious full-bucket
                    variant — every resident row is touched for every
                    query, no data-dependent early exit, so the access
                    trace and `filter_bytes_scanned` are constants.
  oblivious-sketch  hardened, plus a TEE/FHE-hybrid *refine* cost model
                    (`tee_refine_cost`, after Saeki et al., PAPERS.md):
                    the candidate-gather + tournament priced as if it
                    ran inside an enclave with FHE-assisted distance
                    comparison.  The sketch is a measured-constant cost
                    model, not an enclave runtime — the top rung of the
                    frontier is reported, not served.

Profiles never change *results*: dummy rows are dropped before emit,
padding columns are -1 (stripped by `SearchResult.ids_lists`), and the
oblivious scans compute the same distances over a superset of rows —
the cross-profile parity tests pin returned real ids bit-identical to
`perf` across schedulers and placements.
"""

from __future__ import annotations

import dataclasses

__all__ = ["SecurityProfile", "PROFILES", "SECURITY_PROFILE_NAMES",
           "DEFAULT_PROFILE", "get_profile"]

# scheduler batch-padding policies (runtime/batcher.py, slot_loop.py)
PAD_REPLICATE = "replicate"     # pad rows replicate a real query (perf)
PAD_DUMMY = "dummy"             # pad rows are zero dummy queries
PAD_FULL = "full"               # dummy-pad every flush to max_batch

_RESULT_COL_MIN = 16            # smallest padded result-column bucket


def _next_pow2(n: int, minimum: int) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class SecurityProfile:
    """One leakage tier: which observables are flattened, at what cost.

    `pad_policy` drives the schedulers' batch padding, `pad_results`
    the fixed-shape result columns, `oblivious` the full-bucket filter
    scans, `refine` the refine costing (`"dce"` = the served exact
    tournament; `"tee-sketch"` = the DCE tournament served + the
    TEE/FHE-hybrid cost model reported)."""

    name: str
    pad_policy: str = PAD_REPLICATE
    pad_results: bool = False
    oblivious: bool = False
    refine: str = "dce"                  # "dce" | "tee-sketch"
    description: str = ""

    def result_width(self, k: int) -> int:
        """Padded result-column count for a requested k: the next
        power-of-two bucket (>= 16) under padding profiles, exactly k
        under `perf` — so neither k nor per-query hit counts are
        readable off the result wire size."""
        if not self.pad_results:
            return int(k)
        return _next_pow2(int(k), _RESULT_COL_MIN)

    def tee_refine_cost(self, n_candidates: int, d: int) -> dict:
        """The `oblivious-sketch` refine cost model (Saeki et al.,
        PAPERS.md): a TEE-resident tournament whose DCE comparisons are
        FHE-assisted.  Constants: ~40x per-comparison slowdown for the
        in-enclave FHE comparison circuit and a fixed per-batch enclave
        transition (~0.1 ms-equivalent, expressed in comparisons).
        Returns the comparison budget and the multiplier vs the served
        plaintext-speed DCE tournament — the reported (not served) top
        rung of the frontier."""
        comparisons = int(n_candidates) * int(n_candidates)
        fhe_comp_x = 40.0
        enclave_transition_comps = 4096
        total = comparisons * fhe_comp_x + enclave_transition_comps
        return {
            "mode": "tee-sketch",
            "comparisons": comparisons,
            "fhe_comparison_slowdown_x": fhe_comp_x,
            "enclave_transition_comparisons": enclave_transition_comps,
            "est_cost_vs_dce_x": total / max(comparisons, 1),
        }


PROFILES: dict[str, SecurityProfile] = {
    p.name: p for p in (
        SecurityProfile(
            name="perf",
            description="no flattening — fastest; trace/wire observables"
                        " correlate with the workload"),
        SecurityProfile(
            name="balanced",
            pad_policy=PAD_DUMMY,
            pad_results=True,
            description="dummy-query batch padding + fixed-shape results;"
                        " scans unchanged"),
        SecurityProfile(
            name="hardened",
            pad_policy=PAD_FULL,
            pad_results=True,
            oblivious=True,
            description="full-bucket dummy padding + scan-oblivious"
                        " filters; access trace is constant"),
        SecurityProfile(
            name="oblivious-sketch",
            pad_policy=PAD_FULL,
            pad_results=True,
            oblivious=True,
            refine="tee-sketch",
            description="hardened + TEE/FHE-hybrid refine cost model"
                        " (reported, not served)"),
    )
}

SECURITY_PROFILE_NAMES = tuple(PROFILES)
DEFAULT_PROFILE = PROFILES["perf"]


def get_profile(name: str | SecurityProfile) -> SecurityProfile:
    """Resolve a profile by name (idempotent on profile objects)."""
    if isinstance(name, SecurityProfile):
        return name
    try:
        return PROFILES[name]
    except KeyError:
        raise ValueError(f"unknown security profile {name!r} "
                         f"(have {SECURITY_PROFILE_NAMES})") from None
