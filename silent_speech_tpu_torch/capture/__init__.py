"""Data collection (host side, numpy): EMG and audio capture
(``recorder``), the prompting session that writes the dataset's schema
(``session``, with ``book`` for its sentences) and the offline audio
cleaning (``clean_audio``). Own copy of the JAX package's ``capture/``;
nothing here touches a device."""
