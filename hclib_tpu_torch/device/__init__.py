"""Device layer of the port: the scheduler megakernel and its workloads."""
