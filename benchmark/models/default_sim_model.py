"""The model ``default_sim_model``: the source's default regime model with
no calibration. ``program()`` builds the port's tables with the port's own
code; ``reference()`` builds the plain reference's with its copy
(``reference/params.py``), held to the JAX package's tables by
``tests/test_bench_reference.py``."""


def program():
    from letf_tpu_torch.models import params

    return params.default_sim_model()


def reference():
    from benchmark.reference import params

    return params.default_sim_model()
