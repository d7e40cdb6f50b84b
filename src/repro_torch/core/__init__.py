"""FD-SVRG (paper Algorithm 1), serial SVRG, and the outer-loop harness."""
