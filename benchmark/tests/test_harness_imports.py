"""Neither JAX nor the JAX package loads with the harness, and the
reference loads nothing of the program."""

import subprocess
import sys

import cells

FORBIDDEN = ("jax", "jaxlib", "flax", "mcmtt_opticalflow_tpu")


def _tops(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=cells.ROOT, check=True, capture_output=True, text=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_and_port_load_no_jax():
    tops = _tops("import sys; sys.path[:0] = ['benchmark', '.']\n"
                 "import run, check, control, faults, scene, devtrace\n"
                 "import mcmtt_opticalflow_tpu_torch.models.pipeline\n"
                 "from reference import frame3d, tracker2d")
    assert "mcmtt_opticalflow_tpu_torch" in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    tops = _tops("import sys; sys.path[:0] = ['benchmark']\n"
                 "from reference import frame3d, tracker2d, config\n"
                 "import scene, clearmot")
    assert "mcmtt_opticalflow_tpu_torch" not in tops
    assert not tops & set(FORBIDDEN)


def test_forbidden_modules_compares_whole_names():
    import run
    fake = ("mcmtt_opticalflow_tpu_torch_probe.sub", "jax")
    sys.modules[fake[0]] = sys
    try:
        assert run.forbidden_modules() == []
        sys.modules[fake[1]] = sys
        assert run.forbidden_modules() == ["jax"]
    finally:
        for name in fake:
            sys.modules.pop(name, None)
