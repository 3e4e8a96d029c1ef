"""One driver a kind of traffic: ``view`` (viewers asking for frames),
``datagen`` (pseudo-data generation). A traffic file names its kind."""
