"""The benchmark's plain reference: RAFT and its training step in plain
PyTorch. Imports torch only, and nothing of the program under test."""
