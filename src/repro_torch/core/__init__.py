"""FD-SVRG (paper Algorithm 1), serial SVRG, the paper's instance-distributed
baselines (``baselines``: DSVRG, SynSVRG, AsySVRG, PS-Lite SGD), and the
outer-loop harness."""
