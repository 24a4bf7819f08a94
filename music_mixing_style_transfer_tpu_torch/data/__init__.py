from .wavio import (
    read_wav,
    read_wav_stereo_ct,
    read_wav_stereo_ct_i16,
    total_wav_length,
    wav_length,
    write_wav,
)
from .segments import pad_to_batches, reassemble_song, segment_song, segment_song_halo
from .datasets import ContrastivePairDataset, StyleTransferTripletDataset
from .prep import fade_in, fade_out, load_ir_bank, load_wav_dir, random_trim, trim_silence
from .multitrack import (
    MixingDataset,
    mixing_minibatch,
    mixture_minibatch,
    scan_mixing_dataset,
)

__all__ = [
    "ContrastivePairDataset",
    "StyleTransferTripletDataset",
    "MixingDataset",
    "scan_mixing_dataset",
    "mixing_minibatch",
    "mixture_minibatch",
    "fade_in",
    "fade_out",
    "load_ir_bank",
    "load_wav_dir",
    "random_trim",
    "trim_silence",
    "read_wav",
    "read_wav_stereo_ct",
    "read_wav_stereo_ct_i16",
    "wav_length",
    "total_wav_length",
    "write_wav",
    "segment_song",
    "segment_song_halo",
    "reassemble_song",
    "pad_to_batches",
]
