from .wavio import read_wav, read_wav_stereo_ct, read_wav_stereo_ct_i16, write_wav
from .segments import pad_to_batches, reassemble_song, segment_song, segment_song_halo
from .datasets import ContrastivePairDataset, StyleTransferTripletDataset

__all__ = [
    "ContrastivePairDataset",
    "StyleTransferTripletDataset",
    "read_wav",
    "read_wav_stereo_ct",
    "read_wav_stereo_ct_i16",
    "write_wav",
    "segment_song",
    "segment_song_halo",
    "reassemble_song",
    "pad_to_batches",
]
