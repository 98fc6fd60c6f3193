"""The port's API pages: committed ``docs/torch/`` must match a
regeneration by ``tools/gen_docs_torch.py``, byte for byte, and hold no
page the generator would not write."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import gen_docs_torch  # noqa: E402

DOCS = REPO / "docs" / "torch"


@pytest.mark.parametrize("modname", gen_docs_torch.MODULES)
def test_committed_torch_docs_are_fresh(modname):
    page = DOCS / gen_docs_torch.page_name(modname)
    assert page.exists(), (f"docs/torch/{page.name} missing — run "
                           "tools/gen_docs_torch.py")
    assert page.read_text() == gen_docs_torch.render_module(modname), (
        f"docs/torch/{page.name} is stale — run tools/gen_docs_torch.py")


def test_torch_docs_index_is_fresh():
    assert (DOCS / "README.md").read_text() == \
        gen_docs_torch.render_index()


def test_no_orphaned_torch_docs():
    expected = {gen_docs_torch.page_name(m)
                for m in gen_docs_torch.MODULES} | {"README.md"}
    actual = {p.name for p in DOCS.glob("*.md")}
    assert actual == expected, (
        f"orphaned: {actual - expected}, missing: {expected - actual}")


def test_every_port_module_of_the_jax_list_has_a_page():
    # the JAX generator's modules, mapped: ops.cuda_kernels stands for
    # ops.pallas_kernels, the tools their _torch twins
    import gen_docs

    assert len(gen_docs_torch.MODULES) == len(gen_docs.MODULES) + 2
    assert "veles.simd_tpu_torch.ops.cuda_kernels" in gen_docs_torch.MODULES
    assert not any("pallas" in m or m.startswith("veles.simd_tpu.")
                   for m in gen_docs_torch.MODULES)


def test_detect_peaks_page_has_no_inherited_int_member():
    # the JAX page lists ExtremumType.from_bytes on Python 3.12 (an
    # inherited int member); the port's page renders own members only
    page = gen_docs_torch.render_module(
        "veles.simd_tpu_torch.ops.detect_peaks")
    assert "ExtremumType" in page and "from_bytes" not in page
    assert "Members: `MAXIMUM`, `MINIMUM`, `BOTH`" in page
