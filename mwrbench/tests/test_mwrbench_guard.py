"""The import guard: nothing the benchmark runs loads JAX or the JAX
package, and the reference imports nothing of the port."""

import json
import subprocess
import sys
import textwrap

from mwrbench import guard, manifest


def test_forbidden_names_are_compared_whole():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
              guard.JAX_PACKAGE, guard.JAX_PACKAGE + ".models.lbl",
              guard.PORT, guard.PORT + ".models.lbl", "jaxtyping", "numpy"]
    assert guard.forbidden_loaded(loaded) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         guard.JAX_PACKAGE, guard.JAX_PACKAGE + ".models.lbl"])


def test_reference_imports_nothing_of_the_program():
    assert guard.reference_imports_program() == []


def test_reference_check_finds_a_planted_import(tmp_path):
    (tmp_path / "a.py").write_text(f"import {guard.PORT}.models.lbl\n")
    (tmp_path / "b.py").write_text("from jax import numpy\n")
    (tmp_path / "c.py").write_text("from . import physics\nimport numpy\n")
    assert guard.reference_imports_program(tmp_path) == [
        ("a.py", f"{guard.PORT}.models.lbl"), ("b.py", "jax")]


def test_a_run_loads_no_forbidden_module():
    """Every module of the harness, every driver and reader, and a whole
    run of each cell at a small size on the CPU, in a fresh process."""
    code = textwrap.dedent(f"""
        import json, sys, torch
        from mwrbench import control, guard, manifest, run
        bench = manifest.load()
        for kind, key in (("end_to_end", "end_to_end"),
                          ("metrics", "per_layer")):
            for m in bench[key]:
                run.reader(kind, m["name"])
        small = {json.dumps(SMALL)}
        for cell in small:
            run.measure(cell, 5, 0.2, True, torch.device("cpu"), bench,
                        overrides=small[cell])
        guard.check("end")
        print(json.dumps(guard.forbidden_loaded()))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1]) == []


SMALL = {
    "hatpro_archive_b4096": {"batch": 4, "pool": 2, "n_levels": 40,
                             "trace_calls": 2},
    "spectral_channel_design": {"batch": 2, "pool": 2, "n_levels": 40,
                                "n_freqs": 600, "freq_chunk": 256,
                                "trace_calls": 2},
    "hatpro_kmatrix_b256": {"batch": 2, "pool": 2, "n_levels": 40,
                            "trace_calls": 2},
    "campaign_stage_4rel": {"n_time": 6, "n_levels": 40, "invalid": 0.2,
                            "batch_size": 4, "trace_calls": 2},
}
