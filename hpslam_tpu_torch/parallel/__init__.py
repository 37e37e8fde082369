"""Multi-device execution of the port on torch.distributed: the dp x tp
mesh and its collectives (``mesh``) and the tensor-parallel kNN
(``knn_tp``)."""
