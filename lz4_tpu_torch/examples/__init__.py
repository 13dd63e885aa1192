"""Teaching programs of the port (the counterparts of the JAX package's
`examples/`, themselves analogs of the reference's examples/*.c). Each
has a `main()` and runs as `python -m lz4_tpu_torch.examples.<name>`.
Programs on the default backend run on the GPU (`TorchBackend`) unless
given another backend or device; importing one runs nothing."""
