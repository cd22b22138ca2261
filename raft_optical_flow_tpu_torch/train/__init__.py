"""RAFT training: stage configs and the trainer."""
