"""Runnable examples of the port: the multi-raft node drivers.

Run each with `python -m raft_tpu_torch.examples.<name>`.
"""
