"""The simulated end-to-end runs of the JAX package's examples/, ported:
each module has a `run(...)` that takes the sizes and a `main()` that
reads the JAX script's arguments in its order (`--device cpu` to run on
the CPU; cuda otherwise).  Training takes the in-memory route
(pipeline/stages.py image_arrays, polish/pipeline.py polish_train_arrays),
so no run needs h5py."""
