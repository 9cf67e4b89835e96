"""Stochastic-differential-equation processes: the score-SDE family (VP,
sub-VP) and the rectified-flow shell."""
