"""repro_torch.data — synthetic data of the port."""
