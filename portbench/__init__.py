"""The benchmark of the multi-Raft engine's PyTorch and CUDA port,
`raft_tpu_torch`: one command runs one cell (`python3 -m portbench.run`);
see README.md."""
