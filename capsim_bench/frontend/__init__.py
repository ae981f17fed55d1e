"""A frozen copy of the port's numpy front-end, with its imports
retargeted: ``isa/{isa,compiled,funcsim,progen,timing,multicore}.py``,
``core/{standardize,context,slicer,sampler}.py`` and the two dataset
builders of ``data/``.  The benchmark makes every input with it, so the
program under test is handed tokens it did not make, and a later change
to the program's front-end cannot change the benchmark's inputs."""
