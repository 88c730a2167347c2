"""Band-table output, checkpoint/resume, mode dumps and plotting.

Port of ``bravais_tpu/bands/io.py`` (host NumPy; the file names and keys
are the reference's, so a run directory written by either package loads
with the other's ``load_bands``): results land in ``<run_dir>/bands.npz``
plus a JSON manifest holding the config hash and the finished k-points,
so a killed sweep resumes where it stopped. Both files are replaced
atomically, the table first (the reference writes ``bands.npz`` in place,
so a kill during that write leaves a truncated table under a manifest
that names finished k, and its resume fails).
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pathlib
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["BandWriter", "load_bands", "plot_bands", "write_csv",
           "save_modes", "write_vtk"]


@contextlib.contextmanager
def _replacing(path: pathlib.Path):
    """An open binary file whose content replaces ``path`` atomically when
    the block ends (``os.replace`` of a temporary in the same directory);
    if the block raises, ``path`` is left as it was."""
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as f:
            yield f
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


def _config_hash(config: Dict) -> str:
    return hashlib.sha256(
        json.dumps(config, sort_keys=True, default=str).encode()).hexdigest()[:16]


class BandWriter:
    """Incremental, resumable band-table writer."""

    def __init__(self, run_dir, config: Dict, nk: int, nev: int):
        self.dir = pathlib.Path(run_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.nk, self.nev = nk, nev
        self.hash = _config_hash(config)
        self.manifest_path = self.dir / "manifest.json"
        self.bands_path = self.dir / "bands.npz"
        self.manifest = {"config": config, "hash": self.hash, "nk": nk,
                         "nev": nev, "finished": []}
        self.eigenvalues = np.full((nk, nev), np.nan)
        self.iterations = np.zeros(nk, np.int32)
        self.residuals = np.full((nk, nev), np.nan)

    def try_resume(self) -> List[int]:
        """Load previous state if the manifest matches this config.
        Returns the list of finished k indices."""
        if not (self.manifest_path.exists() and self.bands_path.exists()):
            return []
        try:
            man = json.loads(self.manifest_path.read_text())
        except json.JSONDecodeError:
            return []
        if man.get("hash") != self.hash or man.get("nk") != self.nk:
            return []
        dat = np.load(self.bands_path)
        self.eigenvalues = dat["eigenvalues"]
        self.iterations = dat["iterations"]
        self.residuals = dat["residuals"]
        self.manifest = man
        return list(man["finished"])

    def write_chunk(self, idx: Sequence[int], eigenvalues, iterations,
                    residuals) -> None:
        idx = list(int(i) for i in idx)
        self.eigenvalues[idx] = np.asarray(eigenvalues)
        self.iterations[idx] = np.asarray(iterations)
        self.residuals[idx] = np.asarray(residuals)
        self.manifest["finished"] = sorted(
            set(self.manifest["finished"]) | set(idx))
        # Each file is written to a temporary beside it and renamed over
        # it, the table before the manifest: a write cut at any point
        # leaves both files whole, and a manifest never names a k that
        # its table lacks (the table may hold a chunk the manifest does
        # not name yet, which a resume recomputes).
        with _replacing(self.bands_path) as f:
            np.savez(f, eigenvalues=self.eigenvalues,
                     iterations=self.iterations, residuals=self.residuals)
        with _replacing(self.manifest_path) as f:
            f.write(json.dumps(self.manifest, default=str).encode())

    @property
    def finished(self) -> List[int]:
        return list(self.manifest["finished"])


def save_modes(run_dir, k_index: int, k_cart, eigenvalues, X) -> str:
    """Eigenvector (mode) dump for one k-point.

    ``X``: the complex eigenvector block (nev, *dof_shape)
    (``SweepResult.eigenvectors[i]``). Writes ``modes_k####.npz`` with it
    real-stacked as ``X_reim`` (2, nev, *dof_shape), the reference's
    format (reassemble as ``X_reim[0] + 1j*X_reim[1]``), the k-point and
    the eigenvalues."""
    X = np.asarray(X)
    X_reim = np.stack([X.real, X.imag])
    d = pathlib.Path(run_dir)
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"modes_k{int(k_index):04d}.npz"
    np.savez_compressed(path, k_index=int(k_index),
                        k_cart=np.asarray(k_cart),
                        eigenvalues=np.asarray(eigenvalues),
                        X_reim=np.asarray(X_reim))
    return str(path)


def write_vtk(path, grid, fields: Dict[str, np.ndarray]) -> str:
    """Minimal legacy-VTK STRUCTURED_GRID dump of nodal fields on the
    periodic grid. ``fields``: name -> real array of
    shape ``dof_shape`` (scalar) or ``(dim, *dof_shape)`` (vector);
    complex fields should be passed as |field| or Re/Im separately."""
    first = next(iter(fields.values()))
    shp = first.shape[-grid.dim:]
    d = grid.dim
    # nodal fractional coordinates (uniform per-dof spacing)
    axes = [np.arange(nn) / nn for nn in shp]
    mesh = np.meshgrid(*axes, indexing="ij")
    frac = np.stack([m.ravel(order="F") for m in mesh], axis=-1)
    if d == 2:
        frac3 = np.concatenate([frac, np.zeros((len(frac), 1))], axis=1)
        A3 = np.eye(3)
        A3[:2, :2] = grid.lattice.A
    else:
        frac3 = frac
        A3 = grid.lattice.A
    xyz = frac3 @ A3
    npts = xyz.shape[0]
    # VTK expects DIMENSIONS nx ny nz with x fastest; ravel(order='F')
    # makes our axis 0 fastest, so declare shp in axis order.
    lines = ["# vtk DataFile Version 3.0", "bravais_tpu_torch modes",
             "ASCII",
             "DATASET STRUCTURED_GRID",
             "DIMENSIONS " + " ".join(
                 str(s) for s in list(shp) + [1] * (3 - d))]
    lines.append(f"POINTS {npts} double")
    lines.extend(" ".join(f"{v:.9g}" for v in row) for row in xyz)
    lines.append(f"POINT_DATA {npts}")
    for name, arr in fields.items():
        arr = np.asarray(arr)
        if arr.ndim == d:          # scalar
            lines.append(f"SCALARS {name} double 1")
            lines.append("LOOKUP_TABLE default")
            lines.extend(f"{v:.9g}" for v in arr.ravel(order="F"))
        else:                       # vector (dim, *shape)
            lines.append(f"VECTORS {name} double")
            comp = [arr[i].ravel(order="F") for i in range(arr.shape[0])]
            while len(comp) < 3:
                comp.append(np.zeros_like(comp[0]))
            lines.extend(" ".join(f"{c[i]:.9g}" for c in comp)
                         for i in range(npts))
    pathlib.Path(path).write_text("\n".join(lines) + "\n")
    return str(path)


def write_csv(path, kpath, eigenvalues) -> None:
    """Plain-text band table (one row per k: path distance, fractional
    k, bands)."""
    import csv
    nev = eigenvalues.shape[1]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["dist"] + [f"kfrac{i}" for i in
                               range(kpath.k_frac.shape[1])]
                   + [f"band{b}" for b in range(nev)])
        for i in range(kpath.nk):
            w.writerow([f"{kpath.dist[i]:.8g}"]
                       + [f"{x:.8g}" for x in kpath.k_frac[i]]
                       + [f"{v:.10g}" for v in eigenvalues[i]])


def load_bands(run_dir):
    """(the ``bands.npz`` arrays, the manifest) of a run directory."""
    d = pathlib.Path(run_dir)
    dat = np.load(d / "bands.npz")
    man = json.loads((d / "manifest.json").read_text())
    return dat, man


def plot_bands(kpath, eigenvalues, path=None, freq: bool = True,
               title: Optional[str] = None):
    """Band-diagram plot (ω a / 2πc vs k when ``freq``; λ otherwise).
    Needs matplotlib, imported here: without it this raises
    ``ImportError``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    y = np.sqrt(np.maximum(eigenvalues, 0.0)) / (2 * np.pi) if freq \
        else eigenvalues
    fig, ax = plt.subplots(figsize=(6, 4.5))
    for b in range(y.shape[1]):
        for s0, s1 in kpath.segments:
            ax.plot(kpath.dist[s0:s1], y[s0:s1, b], lw=1.2, color="C0")
    for idx, lab in kpath.labels:
        ax.axvline(kpath.dist[idx], color="0.85", lw=0.6, zorder=0)
    ax.set_xticks([kpath.dist[i] for i, _ in kpath.labels])
    ax.set_xticklabels([lab.replace("G", "Γ") for _, lab in kpath.labels])
    ax.set_xlim(kpath.dist[0], kpath.dist[-1])
    ax.set_ylabel("ωa/2πc" if freq else "λ")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=150)
        plt.close(fig)
        return path
    return fig
