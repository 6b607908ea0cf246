"""Multi-process training and evaluation: DP over rays x EP over
categories on torch.distributed (`mesh`, `sharding`, `grid_eval`), the
port's counterpart of the JAX package's `parallel/`."""
