"""Host C++ of the port (own copies of ``audax/native/``): the SF2 synth
(``src/sf2synth.cpp``) and the compressed-audio codec over the system
libav (``src_decode/audio_decode.cpp``), built by ``g++`` at first use
(``build.py``) and bound with ``ctypes`` (``bindings.py``). Neither runs
on the card."""
