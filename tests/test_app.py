"""Streamlit GUI smoke test.

streamlit isn't installed in this image, so the GUI is driven through a
minimal stub that answers every widget call with its smallest/default value
and records what the app displays — proving the full widget -> scene ->
render -> display flow executes (the reference's app.py was checked in
stale and could never run, SURVEY.md §0)."""

import sys
import types

import numpy as np


class _Recorder:
    def __init__(self):
        self.images = []
        self.texts = []


def _make_streamlit_stub(rec: _Recorder):
    st = types.ModuleType("streamlit")

    def selectbox(label, options, **kw):
        return options[0]

    def slider(label, mn, mx, default, **kw):
        return mn  # smallest value -> fast smoke render

    def number_input(label, value=0, **kw):
        return value

    st.title = lambda *a, **k: None
    st.caption = lambda *a, **k: None
    st.button = lambda *a, **k: True  # always "clicked"
    st.image = lambda img, **k: rec.images.append(np.asarray(img))
    st.text = lambda s, **k: rec.texts.append(str(s))
    st.selectbox = selectbox
    st.slider = slider
    st.number_input = number_input
    st.file_uploader = lambda *a, **k: None

    sidebar = types.SimpleNamespace(
        selectbox=selectbox, slider=slider, number_input=number_input,
        file_uploader=st.file_uploader,
    )
    st.sidebar = sidebar
    return st


def test_app_renders_through_stubbed_streamlit(monkeypatch):
    rec = _Recorder()
    monkeypatch.setitem(sys.modules, "streamlit", _make_streamlit_stub(rec))
    import app

    rc = app.main()
    assert rc == 0
    assert len(rec.images) == 1
    img = rec.images[0]
    # smallest slider values: 32x32, spp 1, depth 1
    assert img.shape == (32, 32, 3)
    assert np.isfinite(img).all() and img.min() >= 0 and img.max() <= 1
    assert img.mean() > 0.02  # lit scene, not black
    assert rec.texts and "triangles" in rec.texts[0]


def test_app_degrades_without_streamlit(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "streamlit", None)  # force ImportError
    import importlib

    import app

    importlib.reload(app)
    rc = app.main()
    assert rc == 1
    out = capsys.readouterr().out
    assert "CLI front end" in out
