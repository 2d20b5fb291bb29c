"""The benchmark of ``metagenome_vector_sketches_tpu_torch`` on an NVIDIA
GPU, driven by ``BENCHMARK.json`` at the repository's root.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Layout: ``configs/<name>.json`` (deployments), ``traffic/<name>.json``
(traffic mixes, each naming its driver), ``drivers/<name>.py`` (one
general driver a kind of traffic),
``metrics/<name>.py`` (one reader a metric), ``gen.py`` (inputs from the
seed), ``reference/`` (the plain reference that decides ``correct``),
``roofline.py`` (the card's peaks and each kernel's bound), ``trace.py``
(the profiler's window), ``control.py`` (the control of the check) and
``tests/`` (CPU tests: ``python3 -m pytest portbench/tests``).
Nothing here imports JAX or the JAX package.
"""
