"""The paper's own experiment configs (Table I + §VII-A settings).

Datasets are synthesized at the paper's dimensionalities (offline
container, DESIGN.md §6); beta values follow the paper's tuning rule
("filter-phase recall ceiling near 0.5"), realized here as a fraction of
the legal [sqrt(M), 2 M sqrt(d)] range found by the same grid search.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class ANNConfig:
    name: str
    d: int
    n_paper: int          # the paper's database size
    n_cpu: int            # CPU-feasible default for this container
    beta_fraction: float  # fraction of the legal beta range (recall~0.5)
    sap_s: float = 1024.0
    hnsw_m: int = 16      # paper: 40 (1M+ scale)
    ef_construction: int = 200   # paper: 600
    ratio_k: float = 8.0


DATASETS = {
    "sift1m": ANNConfig("sift1m", d=128, n_paper=1_000_000, n_cpu=20_000,
                        beta_fraction=0.03),
    "gist": ANNConfig("gist", d=960, n_paper=1_000_000, n_cpu=5_000,
                      beta_fraction=0.03),
    "glove": ANNConfig("glove", d=100, n_paper=1_183_514, n_cpu=20_000,
                       beta_fraction=0.03),
    "deep1m": ANNConfig("deep1m", d=96, n_paper=1_000_000, n_cpu=20_000,
                        beta_fraction=0.03),
}


def get_ann_config(name: str) -> ANNConfig:
    return DATASETS[name]
