"""Experiments: measurements that are not on the trainer's path."""
