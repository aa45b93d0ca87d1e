"""The cells a configuration holds, made from the run's seed on the device and handed to the host as CSR.

The genome is ``chip_smoke.py::make_var``, copied (22 autosomes, genes in
proportion to hg38 chromosome lengths), and does not change with the seed.
Cells are log1p-scale values at a fixed density: each detected gene's value
is ``softplus(profile[gene] + noise_sd * N(0, 1))``, where the profile is the
gene's mean, plus the cell type's offset (normal types) or its clone's
copy-number events (malignant cells).  Each clone carries arm- or
chromosome-scale events of ``±event_effect`` on the log scale.

Everything that sets the amount of work is fixed by the configuration, not
by the seed: the sample sizes, the cells of each type and clone, the number
of events of each clone.  The seed chooses the values, the events' places
and signs, and the cells' order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# hg38 autosome lengths (Mb)
CHR_MB = np.array([248, 242, 198, 190, 181, 171, 159, 145, 138, 134, 135, 133,
                   114, 107, 102, 90, 83, 80, 59, 64, 47, 51], dtype=float)
#: rows made at a time on the device
BLOCK_ROWS = 8192
#: where the p arm ends, as a share of a chromosome's length
CENTROMERE = 0.4


def make_var(n_genes: int, seed: int = 0):
    """Genome of the benchmark: 22 autosomes, genes proportional to chromosome length."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    counts = np.maximum(1, (CHR_MB / CHR_MB.sum() * n_genes)).astype(int)
    counts[0] += n_genes - counts.sum()
    rows = []
    for c, k in enumerate(counts):
        starts = np.sort(rng.integers(1, int(CHR_MB[c] * 1e6), size=k))
        rows.extend((f"chr{c + 1}", int(s)) for s in starts)
    var = pd.DataFrame(rows, columns=["chromosome", "start"])
    var["end"] = var["start"] + 1000
    var.index = pd.Index([f"gene_{i}" for i in range(len(var))])
    return var


def seed_state(*words: int) -> np.random.SeedSequence:
    """A seed sequence from the run's seed and sub-stream numbers (any whole numbers)."""
    return np.random.SeedSequence([int(w) % (1 << 64) for w in words])


def _torch_generator(ss: np.random.SeedSequence, device):
    import torch

    g = torch.Generator(device=device)
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0]))
    return g


def sample_sizes(config: dict) -> list[int]:
    """The cell counts of the configuration's samples: evenly spaced quantiles of a log-uniform law."""
    s = config["samples"]
    lo, hi, n = float(s["cells_min"]), float(s["cells_max"]), int(s["count"])
    q = (np.arange(n) + 0.5) / n
    return [int(round(x)) for x in np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))]


@dataclass
class Sample:
    X: object  # scipy.sparse.csr_matrix, float32
    labels: np.ndarray  # cell type of each cell (str)
    reference_cats: list


def _split(n: int, parts: int) -> list[int]:
    base, extra = divmod(n, parts)
    return [base + (i < extra) for i in range(parts)]


def _clone_effects(cells: dict, var, rng: np.random.Generator) -> np.ndarray:
    """(clones, genes) log-scale shift of each clone's copy-number events."""
    chrom = var["chromosome"].astype(str).to_numpy()
    length = {f"chr{i + 1}": mb * 1e6 for i, mb in enumerate(CHR_MB)}
    frac = var["start"].to_numpy() / np.array([length.get(c, np.inf) for c in chrom])
    lo, hi = cells["event_effect"]
    out = np.zeros((int(cells["clones"]), len(var)))
    for c, n_events in enumerate(cells["events_per_clone"]):
        for _ in range(int(n_events)):
            on = chrom == f"chr{int(rng.integers(1, 23))}"
            scope = int(rng.integers(0, 3))  # whole chromosome, p arm, q arm
            if scope == 1:
                on &= frac < CENTROMERE
            elif scope == 2:
                on &= frac >= CENTROMERE
            out[c, on] += rng.choice([-1.0, 1.0]) * rng.uniform(lo, hi)
    return out


def make_sample(config: dict, var, n_cells: int, seed: int, index: int, device) -> Sample:
    """Sample ``index`` of the configuration at ``n_cells`` cells, from ``seed``, made on ``device``."""
    import scipy.sparse as sp
    import torch
    import torch.nn.functional as F

    cells = config["cells"]
    n_genes = len(var)
    # what all samples of one run share: the genes' means and the normal types' offsets
    shared = np.random.default_rng(seed_state(seed, 0))
    gene_mean = shared.uniform(*cells["gene_mean"], size=n_genes)
    n_types = int(cells["normal_types"])
    offsets = shared.normal(0.0, float(cells["type_offset_sd"]), size=(n_types, n_genes))
    rng = np.random.default_rng(seed_state(seed, 1, index))
    effects = _clone_effects(cells, var, rng)
    table = np.concatenate([gene_mean + effects, gene_mean + offsets]).astype(np.float32)
    names = [f"clone_{i}" for i in range(len(effects))] + [f"normal_{i}" for i in range(n_types)]

    n_mal = int(round(n_cells * float(cells["malignant_share"])))
    counts = _split(n_mal, len(effects)) + _split(n_cells - n_mal, n_types)
    profile = rng.permutation(np.repeat(np.arange(len(names)), counts))
    labels = np.asarray(names, dtype=object)[profile]

    g = _torch_generator(seed_state(seed, 2, index), device)
    table_t = torch.from_numpy(table).to(device)
    profile_t = torch.from_numpy(profile).to(device)
    density, noise = float(cells["density"]), float(cells["noise_sd"])
    indices, data, row_nnz = [], [], []
    for lo in range(0, n_cells, BLOCK_ROWS):
        rows = min(BLOCK_ROWS, n_cells - lo)
        mask = torch.rand((rows, n_genes), generator=g, device=device) < density
        r, c = mask.nonzero(as_tuple=True)
        z = table_t[profile_t[lo + r], c] + noise * torch.randn(r.numel(), generator=g, device=device)
        indices.append(c.to(torch.int32).cpu().numpy())
        data.append(F.softplus(z).cpu().numpy())
        row_nnz.append(mask.sum(dim=1).cpu().numpy())
        del mask, r, c, z
    indptr = np.concatenate([[0], np.cumsum(np.concatenate(row_nnz))]).astype(np.int64)
    X = sp.csr_matrix((np.concatenate(data), np.concatenate(indices), indptr), shape=(n_cells, n_genes))
    ref = [f"normal_{i}" for i in range(int(cells["reference_types"]))]
    return Sample(X=X, labels=labels, reference_cats=ref)


def make_anndata(sample: Sample, var):
    """The port's AnnData of one sample (``obs["cell_type"]`` categorical)."""
    import pandas as pd

    from infercnvpy_tpu_torch import AnnData

    n = sample.X.shape[0]
    obs = pd.DataFrame({"cell_type": pd.Categorical(sample.labels)},
                       index=pd.Index([f"cell_{i}" for i in range(n)]))
    return AnnData(X=sample.X, obs=obs, var=var.copy())
