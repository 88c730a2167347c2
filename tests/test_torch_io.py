"""Checkpoint writes that a kill cannot leave half done.

``BandWriter.write_chunk`` writes ``bands.npz`` and then the manifest,
each to a temporary file beside it that replaces it. Two interruptions,
made deterministic here:

* ``np.savez`` writes part of the table and fails (a kill during the
  write): the live files are still the last chunk's and the resume
  returns the k finished before (written in place, as the reference
  writes it, the live ``bands.npz`` is truncated under a manifest that
  names finished k, and the resume raises ``BadZipFile``);
* the run stops between the two replaces: the table holds the new chunk
  and the manifest does not name it yet, so the resume recomputes that
  chunk and nothing before it.
"""

import io
import os

import numpy as np
import pytest

from bravais_tpu_torch.bands import io as bands_io
from bravais_tpu_torch.bands.io import BandWriter

CFG = {"lattice": "SQR", "n": 8, "p": 2}
NK, NEV = 6, 2


def _rows(idx):
    idx = np.asarray(idx)
    return (np.stack([idx + 0.5, idx + 1.5], axis=1), idx + 10,
            np.full((len(idx), NEV), 1e-9))


def _written(tmp_path):
    w = BandWriter(tmp_path, CFG, NK, NEV)
    w.write_chunk([0, 1, 2], *_rows([0, 1, 2]))
    return w


def _resumes_first_chunk(tmp_path):
    """The resume finds the first chunk, and its rows, finished."""
    w = BandWriter(tmp_path, CFG, NK, NEV)
    assert w.try_resume() == [0, 1, 2]
    lam, its, res = _rows([0, 1, 2])
    np.testing.assert_array_equal(w.eigenvalues[:3], lam)
    np.testing.assert_array_equal(w.iterations[:3], its)
    return w


def test_savez_cut_mid_write_leaves_a_resumable_run(tmp_path, monkeypatch):
    w = _written(tmp_path)
    real = np.savez

    def cut(file, **arrays):
        buf = io.BytesIO()
        real(buf, **arrays)
        part = buf.getvalue()[:buf.tell() // 2]
        if isinstance(file, (str, os.PathLike)):
            with open(file, "wb") as f:
                f.write(part)
        else:
            file.write(part)
        raise OSError("killed mid-write")

    monkeypatch.setattr(np, "savez", cut)
    with pytest.raises(OSError, match="killed mid-write"):
        w.write_chunk([3, 4], *_rows([3, 4]))
    monkeypatch.undo()
    assert np.isnan(_resumes_first_chunk(tmp_path).eigenvalues[3:]).all()
    assert sorted(os.listdir(tmp_path)) == ["bands.npz", "manifest.json"]


def test_stop_between_the_replaces_recomputes_the_last_chunk(
        tmp_path, monkeypatch):
    w = _written(tmp_path)
    real, calls = os.replace, []

    def second_fails(src, dst):
        calls.append(dst)
        if len(calls) == 2:
            raise OSError("killed between the replaces")
        real(src, dst)

    monkeypatch.setattr(bands_io.os, "replace", second_fails)
    with pytest.raises(OSError, match="between the replaces"):
        w.write_chunk([3, 4], *_rows([3, 4]))
    monkeypatch.undo()
    assert [os.path.basename(c) for c in calls] == ["bands.npz",
                                                     "manifest.json"]
    _resumes_first_chunk(tmp_path)
    w2 = BandWriter(tmp_path, CFG, NK, NEV)
    todo = [i for i in range(NK) if i not in set(w2.try_resume())]
    assert todo == [3, 4, 5]
    w2.write_chunk(todo, *_rows(todo))
    w3 = BandWriter(tmp_path, CFG, NK, NEV)
    assert w3.try_resume() == list(range(NK))
    np.testing.assert_array_equal(w3.eigenvalues, _rows(range(NK))[0])
