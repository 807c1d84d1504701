"""The benchmark's tests, a package so that its ``conftest`` is
``portbench.tests.conftest`` and never shadows another ``conftest`` in a
run that collects both."""
