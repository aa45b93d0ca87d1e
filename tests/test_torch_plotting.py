"""The port's ``pl`` against ``infercnvpy_tpu.pl`` on the Agg backend, with the same AnnData contents.

What each figure shows must be equal, exactly: the row order, the heatmap's
image array, its norm, the chromosome ticks and labels, the group band and
its labels, the summary matrix, and for the embeddings the scatter offsets,
face colours, legend labels and colour bars.  The port closes every figure
it makes (the JAX package leaves them open in pyplot); the axes it returns
keep working.  The JAX package's figures are closed here after each call.
"""

import io

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import numpy.testing as npt  # noqa: E402
import pytest  # noqa: E402
import scipy.sparse as sp  # noqa: E402

torch = pytest.importorskip("torch")

import infercnvpy_tpu as cnv  # noqa: E402
import infercnvpy_tpu.pl._chromosome_heatmap as jheat  # noqa: E402
import infercnvpy_tpu_torch as tcnv  # noqa: E402
import infercnvpy_tpu_torch.pl._chromosome_heatmap as theat  # noqa: E402
from infercnvpy_tpu import settings as jsettings  # noqa: E402
from infercnvpy_tpu_torch import settings as tsettings  # noqa: E402

CATS = ["Microglia/Macrophage", "Oligodendrocytes (non-malignant)"]
REPS = {"dense": np.asarray, "csr": sp.csr_matrix, "csc": sp.csc_matrix}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_open_figures():
    plt.close("all")
    yield
    plt.close("all")


@pytest.fixture(scope="module")
def analysed():
    """The 183-cell dataset through the port's CPU workflow: ``X_cnv``, Leiden, score, UMAP, t-SNE."""
    adata = tcnv.datasets.oligodendroglioma()
    tcnv.tl.infercnv(adata, reference_key="cell_type", reference_cat=CATS, device="cpu")
    tcnv.tl.pca(adata, device="cpu")
    tcnv.pp.neighbors(adata, device="cpu")
    tcnv.tl.leiden(adata)
    tcnv.tl.cnv_score(adata, device="cpu")
    tcnv.tl.umap(adata, device="cpu", n_epochs=50)
    tcnv.tl.tsne(adata, device="cpu", n_iter=250)
    assert adata.obs["cnv_leiden"].nunique() >= 3  # dendrogram=True reorders from 3 groups on
    return adata


def _pair(analysed, rep="csr", leiden=True):
    """Port and JAX AnnData holding the same obs, ``X_cnv`` (as ``rep``), embeddings and ``uns["cnv"]``."""
    out = []
    for pkg in (tcnv, cnv):
        cols = ["cell_type", "cnv_score"] + (["cnv_leiden"] if leiden else [])
        a = pkg.AnnData(X=analysed.X, obs=analysed.obs[cols].copy(), var=analysed.var.copy())
        a.obsm["X_cnv"] = REPS[rep](analysed.obsm["X_cnv"].toarray())
        for key in ("X_cnv_umap", "X_cnv_tsne", "X_cnv_pca"):
            a.obsm[key] = analysed.obsm[key].copy()
        a.uns["cnv"] = {"chr_pos": dict(analysed.uns["cnv"]["chr_pos"])}
        out.append(a)
    return out


def _jax_call(fn, *args, **kwargs):
    """The JAX package's plot; its figure is closed here, since the JAX package leaves it open."""
    try:
        return fn(*args, **kwargs)
    finally:
        plt.close("all")


def _port_call(fn, *args, **kwargs):
    """The port's plot: it must leave pyplot's figure list as it found it."""
    before = plt.get_fignums()
    out = fn(*args, **kwargs)
    assert plt.get_fignums() == before
    return out


def _image(im):
    arr = im.get_array()
    return np.ma.getdata(arr), np.ma.getmaskarray(arr)


def _heatmap_state(axes) -> dict:
    ax, gax = axes["heatmap_ax"], axes["groupby_ax"]
    im = ax.images[0]
    data, mask = _image(im)
    return {
        "array": data,
        "mask": mask,
        "norm": (im.norm.vmin, im.norm.vcenter, im.norm.vmax),
        "cmap": im.cmap.name,
        "interpolation": im.get_interpolation(),
        "alpha": im.get_alpha(),
        "xticks": np.asarray(ax.get_xticks()),
        "xticklabels": [t.get_text() for t in ax.get_xticklabels()],
        "lines": [np.asarray(c.get_segments()) for c in ax.collections],
        "band": _image(gax.images[0])[0],
        "band_labels": [(t.get_text(), t.get_position()) for t in gax.texts],
        "figsize": tuple(ax.figure.get_size_inches()),
        "colorbar_label": ax.images[0].colorbar.ax.get_ylabel(),
    }


def _assert_same_state(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key in want:
        g, w = got[key], want[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            npt.assert_array_equal(g, w, err_msg=key)
        elif key == "lines":
            assert len(g) == len(w)
            for a, b in zip(g, w):
                npt.assert_array_equal(a, b, err_msg=key)
        else:
            assert g == w, key


@pytest.mark.parametrize("dendrogram", [False, True], ids=["groups", "dendrogram"])
@pytest.mark.parametrize("groupby", ["cnv_leiden", "cell_type"])
@pytest.mark.parametrize("rep", list(REPS))
def test_chromosome_heatmap(analysed, rep, groupby, dendrogram):
    a_t, a_j = _pair(analysed, rep)
    kw = dict(groupby=groupby, dendrogram=dendrogram, show=False)
    got = _heatmap_state(_port_call(tcnv.pl.chromosome_heatmap, a_t, **kw))
    want = _heatmap_state(_jax_call(cnv.pl.chromosome_heatmap, a_j, **kw))
    _assert_same_state(got, want)

    # the image is X_cnv's rows in the group order
    X = analysed.obsm["X_cnv"].toarray()
    order, cats, rows = theat._group_order(a_t, groupby)
    j_order, j_cats, j_rows = jheat._group_order(a_j, groupby)
    npt.assert_array_equal(order, j_order)
    assert cats == j_cats
    npt.assert_array_equal(rows, j_rows)
    if dendrogram:
        values = np.asarray(a_t.obs[groupby])
        present = [c for c in cats if (values == c).any()]
        groups = theat._dendrogram_group_order(X, present, values)
        assert groups == jheat._dendrogram_group_order(X, present, values)
        rank = {g: i for i, g in enumerate(groups)}
        order = np.argsort([rank[v] for v in values], kind="stable")
    npt.assert_array_equal(got["array"], X[order])
    assert got["xticklabels"] == list(a_t.uns["cnv"]["chr_pos"])


@pytest.mark.parametrize("dendrogram", [False, True], ids=["groups", "dendrogram"])
@pytest.mark.parametrize("groupby", ["cnv_leiden", "cell_type"])
@pytest.mark.parametrize("rep", list(REPS))
def test_chromosome_heatmap_summary(analysed, rep, groupby, dendrogram):
    a_t, a_j = _pair(analysed, rep)
    kw = dict(groupby=groupby, dendrogram=dendrogram, show=False)
    got = _heatmap_state(_port_call(tcnv.pl.chromosome_heatmap_summary, a_t, **kw))
    want = _heatmap_state(_jax_call(cnv.pl.chromosome_heatmap_summary, a_j, **kw))
    _assert_same_state(got, want)
    X = analysed.obsm["X_cnv"].toarray()
    labels = [t for t, _ in got["band_labels"]]
    means = np.vstack([X[np.asarray(a_t.obs[groupby] == g)].mean(axis=0) for g in labels])
    # float32 means summed in another order than scipy's sparse mean
    npt.assert_allclose(got["array"], means, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize(
    "kwargs",
    [dict(vmin=-0.3, vmax=0.4, cmap="RdBu_r"), dict(vmin=0.1), dict(vmax=-0.1), dict(alpha=0.5, figsize=(6, 4))],
    ids=["limits_cmap", "vmin_positive", "vmax_negative", "imshow_kwargs"],
)
@pytest.mark.parametrize("summary", [False, True], ids=["heatmap", "summary"])
def test_heatmap_options(analysed, summary, kwargs):
    a_t, a_j = _pair(analysed)
    fn_t = tcnv.pl.chromosome_heatmap_summary if summary else tcnv.pl.chromosome_heatmap
    fn_j = cnv.pl.chromosome_heatmap_summary if summary else cnv.pl.chromosome_heatmap
    got = _heatmap_state(_port_call(fn_t, a_t, show=False, **kwargs))
    _assert_same_state(got, _heatmap_state(_jax_call(fn_j, a_j, show=False, **kwargs)))


@pytest.mark.parametrize("summary", [False, True], ids=["heatmap", "summary"])
def test_heatmap_requires_leiden(analysed, summary):
    a_t, a_j = _pair(analysed, leiden=False)
    name = "chromosome_heatmap_summary" if summary else "chromosome_heatmap"
    with pytest.raises(ValueError) as got:
        _port_call(getattr(tcnv.pl, name), a_t, show=False)
    with pytest.raises(ValueError) as want:
        _jax_call(getattr(cnv.pl, name), a_j, show=False)
    assert str(got.value) == str(want.value) == "'cnv_leiden' is not in `adata.obs`. Did you run `tl.leiden()`?"


def _embedding_state(axes) -> list:
    axes = axes if isinstance(axes, list) else [axes]
    out = []
    for ax in axes:
        legend = ax.get_legend()
        state = {
            "offsets": [np.asarray(c.get_offsets()) for c in ax.collections],
            "facecolors": [np.asarray(c.get_facecolors()) for c in ax.collections],
            "arrays": [None if c.get_array() is None else np.asarray(c.get_array()) for c in ax.collections],
            "legend": None if legend is None else [t.get_text() for t in legend.get_texts()],
            "labels": (ax.get_title(), ax.get_xlabel(), ax.get_ylabel()),
            "colorbars": [],
        }
        for c in ax.collections:
            if c.colorbar is not None:
                cb = c.colorbar
                state["colorbars"].append((cb.ax.get_ylabel(), cb.norm.vmin, cb.norm.vmax, cb.cmap.name))
        out.append(state)
    return out


def _assert_same_embedding(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("offsets", "facecolors", "arrays"):
            assert len(g[key]) == len(w[key]), key
            for a, b in zip(g[key], w[key]):
                if b is None:
                    assert a is None
                else:
                    npt.assert_array_equal(a, b, err_msg=key)
        for key in ("legend", "labels", "colorbars"):
            assert g[key] == w[key], key


EMBEDDINGS = [
    ("umap", None, None),
    ("umap", None, "cnv_leiden"),
    ("umap", None, "cnv_score"),
    ("tsne", None, "cell_type"),
    ("tsne", None, ["cell_type", "cnv_score"]),
    ("embedding", "cnv_pca", "cnv_leiden"),
    ("embedding", "X_cnv_umap", ["cnv_leiden", "cell_type", "cnv_score"]),
]


@pytest.mark.parametrize(
    "fn,basis,color", EMBEDDINGS, ids=[f"{f}-{b}-{c}" for f, b, c in EMBEDDINGS]
)
def test_embedding(analysed, fn, basis, color):
    a_t, a_j = _pair(analysed)
    args = (basis,) if basis else ()
    got = _port_call(getattr(tcnv.pl, fn), a_t, *args, color=color, show=False)
    want = _jax_call(getattr(cnv.pl, fn), a_j, *args, color=color, show=False)
    got_state = _embedding_state(got)
    _assert_same_embedding(got_state, _embedding_state(want))
    assert sum(len(s["colorbars"]) for s in got_state) == (
        color == "cnv_score" or (isinstance(color, list) and "cnv_score" in color)
    )


def test_embedding_missing_basis(analysed):
    a_t, a_j = _pair(analysed)
    with pytest.raises(KeyError) as got:
        _port_call(tcnv.pl.embedding, a_t, "nope", show=False)
    with pytest.raises(KeyError) as want:
        _jax_call(cnv.pl.embedding, a_j, "nope", show=False)
    assert str(got.value) == str(want.value)


PLOTS = [
    ("chromosome_heatmap", (), "heatmap"),
    ("chromosome_heatmap_summary", (), "heatmap"),
    ("umap", (), "cnv_umap"),
    ("tsne", (), "cnv_tsne"),
    ("embedding", ("cnv_pca",), "cnv_pca"),
]


@pytest.mark.parametrize("save", [".png", True, ".pdf"], ids=["png", "true", "pdf"])
@pytest.mark.parametrize("fn,args,stem", PLOTS, ids=[p[0] for p in PLOTS])
def test_save_writes_to_the_ports_figdir(analysed, tmp_path, monkeypatch, fn, args, stem, save):
    monkeypatch.setattr(tsettings, "figdir", tmp_path / "port")
    monkeypatch.setattr(jsettings, "figdir", tmp_path / "jax")
    a_t, _ = _pair(analysed)
    axes = _port_call(getattr(tcnv.pl, fn), a_t, *args, show=False, save=save)
    assert axes is not None
    suffix = ".png" if save is True else save
    written = tmp_path / "port" / f"{stem}{suffix}"
    assert written.exists() and written.stat().st_size > 0
    assert [p.name for p in (tmp_path / "port").iterdir()] == [written.name]
    assert not (tmp_path / "jax").exists()


@pytest.mark.parametrize("autoshow", [False, True], ids=["autoshow_off", "autoshow_on"])
@pytest.mark.parametrize("fn,args,stem", PLOTS, ids=[p[0] for p in PLOTS])
def test_show_none_follows_autoshow(analysed, monkeypatch, fn, args, stem, autoshow):
    shown = []
    monkeypatch.setattr(plt, "show", lambda *a, **k: shown.append(plt.get_fignums()))
    monkeypatch.setattr(tsettings, "autoshow", autoshow)
    a_t, _ = _pair(analysed)
    out = _port_call(getattr(tcnv.pl, fn), a_t, *args)
    if autoshow:
        assert out is None
        assert len(shown) == 1 and len(shown[0]) == 1  # the figure was open while it was shown
    else:
        assert out is not None and shown == []
    shown.clear()
    out = _port_call(getattr(tcnv.pl, fn), a_t, *args, show=not autoshow)
    assert (out is None) is (not autoshow) and len(shown) == int(not autoshow)


@pytest.mark.parametrize("fn,args,stem", PLOTS, ids=[p[0] for p in PLOTS])
def test_no_figure_left_open_and_axes_still_work(analysed, fn, args, stem):
    """The repaired leak: the calls leave ``plt.get_fignums()`` as it was, and the axes they return still draw."""
    a_t, _ = _pair(analysed)
    before = plt.get_fignums()
    outs = [getattr(tcnv.pl, fn)(a_t, *args, show=False) for _ in range(3)]
    assert plt.get_fignums() == before == []
    for out in outs:
        ax = out["heatmap_ax"] if isinstance(out, dict) else out
        ax.set_title("still usable")
        buf = io.BytesIO()
        ax.figure.savefig(buf, format="png")
        assert buf.getvalue()[:8] == b"\x89PNG\r\n\x1a\n"
        if isinstance(out, dict):
            assert _image(ax.images[0])[0].shape[1] == a_t.obsm["X_cnv"].shape[1]
        else:
            assert np.asarray(ax.collections[0].get_offsets()).shape[1] == 2
    assert plt.get_fignums() == []
