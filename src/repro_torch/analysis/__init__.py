"""Cost and roofline analysis of one rank's step, for the dry run
(``launch.dryrun``): ``cost`` counts a step as dispatched, ``roofline``
puts the counts against the H100's peaks, ``report`` renders tables."""
